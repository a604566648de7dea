"""Build and bind the hand-written CUDA kernels under `csrc/`.

At first use the sources are compiled by `nvcc` for Hopper (`sm_90a`), one
process per source, all started together, linked into one shared library
with a plain C interface in `build/` beside the package, and loaded with
ctypes.  Every kernel entry point takes its device
pointers (`tensor.data_ptr()`) and the current CUDA stream as `void*`,
launches without synchronising, and returns the `cudaGetLastError()` of the
launch; `launch` raises on a non-zero status and counts the launch.

Nothing here runs at import: the CPU path never needs nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

from . import spans

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
LIB_PATH = BUILD_DIR / "libwebp_tpu_torch_kernels.so"
PTXAS_REPORT = BUILD_DIR / "ptxas.txt"  # each kernel's registers, shared memory and spills
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# C entry point -> argument types (the trailing stream included).
_SIGNATURES = {
    "webp_residual": [
        _P, _P, _I,          # bitmap, vals, cap_mb
        _P, _P, _I,          # esc_pos, esc_val, n_esc
        _P, _L,              # dense int16 levels, row stride
        _P, _L,              # qtab, row stride
        _P, _L, _P, _L,      # segment_ids, luma_mode (+ batch strides)
        _P, _L, _P, _L,      # skipped, non_zero (+ batch strides)
        _I, _I,              # nmb, batch
        _P, _P,              # residuals out, do_sub out
        _P,                  # stream
    ],
    "webp_recon": [
        _P,                  # residuals
        _P, _L, _P, _L, _P, _L,   # luma_mode, bpred, chroma_mode (+ batch strides)
        _I, _I, _I,          # mbw, mbh, batch
        _P, _L, _P, _L, _P, _L,   # y, u, v planes (+ batch strides)
        _P, _P,              # edge-row scratch, row progress counters and ticket (zeroed)
        _P,
    ],
    "webp_loopfilter": [
        _P, _L, _P, _L, _P, _L,   # y, u, v planes (+ batch strides), in place
        _P, _L, _P, _L, _P, _L, _P, _L,  # level, interior, hev, do_sub
        _I, _I, _I, _I,      # mbw, mbh, batch, simple
        _P,                  # row progress counters and ticket (zeroed)
        _P,
    ],
    "webp_recon_filter": [
        _P,                  # residuals
        _P, _L, _P, _L, _P, _L,   # luma_mode, bpred, chroma_mode (+ batch strides)
        _P, _L, _P, _L, _P, _L, _P, _L,  # level, interior, hev, do_sub
        _I, _I, _I, _I,      # mbw, mbh, batch, simple
        _P, _L, _P, _L, _P, _L,   # y, u, v planes (+ batch strides), out
        _P, _P,              # edge-row scratch, row progress counters and ticket (zeroed)
        _P,
    ],
    "webp_handoff_chain": [_I, _P, _P],  # CTAs, flags [n + 1] (zeroed)
    "webp_yuv2rgb": [
        _P, _L, _P, _L, _P, _L,   # y, u, v planes (+ batch strides)
        _I, _I, _I, _I, _I,  # mbw, mbh, width, height, batch
        _P,                  # rgb out [B, height, width, 3]
        _P,
    ],
    "webp_enc": [
        _P, _L, _P, _L, _P, _L,   # source y, u, v planes (+ batch strides)
        _P, _L, _P, _L,      # segment params, MB segment ids or null (+ batch strides)
        _P,                  # constant tables
        _P, _L, _P, _L, _P, _L,   # cls, eob, init cost tables (+ batch strides)
        _I, _I, _I, _I, _I,  # mbw, mbh, batch, n_try, do_trellis
        _P, _P, _P, _P, _P, _P,   # luma_mode, chroma_mode, bpred, y, y2, uv levels out
        _P, _P, _P,          # edge-row, diffusion-error and nnz-mask scratch
        _P,                  # row progress counters and ticket (zeroed)
        _P,
    ],
    "webp_analysis": [
        _P, _L, _P, _L, _P, _L,   # y, u, v planes (+ batch strides)
        _I, _I, _I, _I,      # mbw, mbh, batch, MBs a CTA takes from a row
        _P, _P,              # alpha out [B, nmb] int32, uv_alpha out [B] int32
        _P,                  # per-image (chroma sum, ticket) [B, 2] uint64, kept zeroed
        _P,
    ],
    "webp_token_stats": [
        _P, _L, _P, _L,      # luma_mode, skipped or null (+ batch strides)
        _P, _P, _P,          # y2, y, uv levels
        _I, _I, _I, _I, _I,  # mbw, mbh, batch, MBs a CTA takes from a row, rows a scan chunk
        _P,                  # (totals, ones) out
        _P,                  # per-image counters and ticket [B, 2113] int32, kept zeroed
        _P,
    ],
    "webp_enc_tables": [
        _P, _P, _I,          # probs, constant tables, batch
        _P, _P, _P, _P,      # pos, cls, eob, init costs out
        _P,
    ],
    "webp_vp8l_subtract_green": [_P, _L, _P],   # pixels (in place), pixel count
    "webp_vp8l_color_transform": [
        _P, _P,              # pixels (in place), transform image [B, bh, bw, 4]
        _I, _I, _I, _I,      # size_bits, w, h, batch
        _P,
    ],
    "webp_vp8l_color_indexing": [
        _P, _I, _P, _I,      # packed pixels, packed width, palettes [B, 256, 4], table_size
        _I, _I, _I,          # width, h, batch
        _P,                  # pixels out [B, h, width, 4]
        _P,
    ],
    "webp_vp8l_predictor": [
        _P, _P,              # pixels (in place), modes [B, bh, bw]
        _I, _I, _I, _I,      # size_bits, w, h, batch
        _P, _P,              # edge-row scratch [B, bands, w], band progress and ticket (zeroed)
        _P,
    ],
    "webp_coeff_tokens": [
        _P, _L,              # luma_mode (+ batch stride)
        _P, _P, _P,          # y2, y, uv levels
        _P, _P, _I,          # probs [B, 1056], constant tables and their count
        _I, _I, _I, _I, _I,  # mbw, mbh, batch, partitions, byte capacity
        _P, _P, _P,          # bytes [B, P, cap], carry-mask scratch, fields [B, P, 6] out
        _P,
    ],
    "webp_coder_chain": [
        _P, _I, _I,          # ops uint16 [ring], passes over them, byte capacity
        _P, _P, _P,          # bytes [cap], carry-mask scratch, fields [6] out
        _P,
    ],
    "webp_mb_headers": [
        _P, _L, _P, _L, _P, _L,   # luma_mode, bpred, chroma_mode (+ batch strides)
        _P, _L, _P, _L,      # segment ids, skipped (+ batch strides)
        _P, _P, _I,          # per-image parameters [B, 8], constant tables and their count
        _I, _I, _I, _I,      # mbw, mbh, batch, byte capacity
        _P, _P,              # bytes [B, cap], carry-mask scratch
        _P, _I,              # op-stream scratch [B, op_cap] uint16, op_cap
        _P,                  # fields [B, 6] out
        _P,
    ],
    "webp_recon_banded": [
        _P,                  # residuals
        _P, _L, _P, _L, _P, _L,   # luma_mode, bpred, chroma_mode (+ batch strides)
        _I, _I, _I, _I,      # mbw, mbh, batch, n_band
        _P, _L, _P, _L, _P, _L,   # y, u, v planes (+ batch strides)
        _P,                  # edge-row scratch [B, mbh, 2W]
        _P,
    ],
    "webp_filter_banded": [
        _P, _L, _P, _L, _P, _L,   # y, u, v planes (+ batch strides), in place
        _P, _L, _P, _L, _P, _L, _P, _L,  # level, interior, hev, do_sub
        _I, _I, _I, _I, _I,  # mbw, mbh, batch, simple, n_band
        _P,
    ],
    "webp_band_handoff_chain": [_I, _I, _I, _P],  # CTAs of a cluster, warps of a CTA, rounds
    "webp_bool_lanes": [
        _P, _P, _P, _I, _I,  # bits, probs, valid [T, L]; T, L
        _P, _I,              # initial states [L, 3], byte capacity
        _P, _P, _P,          # bytes [L, cap], carry-mask scratch, fields [L, 6] out
        _P,
    ],
    "webp_prepack": [
        _P, _P, _P,          # y, uv, y2 levels
        _P, _L, _P, _L, _P, _L,   # luma_mode, chroma_mode, bpred (+ batch strides)
        _I, _I,              # nmb, batch
        _P, _P, _P, _P, _P,  # lv8, meta8, esc_pos, esc_val, overflow (zeroed) out
        _P,
    ],
    "webp_pack_levels": [
        _P, _I, _I, _I,      # lv8, nmb, batch, cap_mb
        _P, _P, _P,          # bitmap, vals, overflow (zeroed) out
        _P,
    ],
    "webp_prepack_pack": [
        _P, _P, _P,          # y, uv, y2 levels
        _P, _L, _P, _L, _P, _L,   # luma_mode, chroma_mode, bpred (+ batch strides)
        _I, _I,              # nmb, batch
        _P, _P, _P, _P, _P,  # lv8, meta8, esc_pos, esc_val, overflow (zeroed) out
        _P, _P, _P,          # bitmap, vals [B, nmb, 256], sp_over (zeroed) out
        _P,
    ],
    "webp_wire": [
        _P, _P, _P, _P, _P,  # bitmap, vals, meta8, esc_pos, esc_val
        _P, _P,              # sp_over, overflow [B] bool
        _I, _I,              # nmb, batch
        _P, _P,              # ticket words [B] uint64 (kept zeroed), wire rows out
        _P,
    ],
    "webp_pack_flat": [
        _P, _L, _I, _I,      # flat int8 [B, N], N, batch, cap
        _P,                  # tickets and tile statuses [B + B * ceil(N / 8192)] uint64, kept zeroed
        _P, _P, _P,          # bitmap, vals, overflow out
        _P,
    ],
    "webp_expand_flat": [
        _P, _L, _P, _I,      # bitmap [B, nb], nb, vals [B, cap], cap
        _L, _I,              # n, batch
        _P,                  # tickets and tile statuses [B + B * ceil(n / 8192)] uint64, kept zeroed
        _P,                  # int8 [B, n] out
        _P,
    ],
}

# Kernel name -> launches since the last reset_launches().  Each wrapper
# counts here, and only when its kernel was launched.
LAUNCHES = {"residual": 0, "recon": 0, "loopfilter": 0, "recon_filter": 0, "yuv2rgb": 0,
            "enc": 0, "token_stats": 0, "enc_tables": 0, "analysis": 0,
            "subtract_green": 0, "color_transform": 0, "color_indexing": 0, "predictor": 0,
            "coeff_tokens": 0, "mb_headers": 0, "bool_lanes": 0,
            "recon_banded": 0, "filter_banded": 0,
            "prepack": 0, "pack_levels": 0, "prepack_pack": 0, "wire": 0, "pack_flat": 0,
            "expand_flat": 0}

_lib = None
_entries = {}  # C entry point -> its bound function in _lib
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _build() -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    nvcc = _nvcc()
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):  # one nvcc per source, all at once
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
                                       str(src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors, reports = [], []
    for proc in procs:
        _, err = proc.communicate()
        reports.append(err)
        if proc.returncode != 0:
            errors.append(f"nvcc {proc.args[-1]} failed ({proc.returncode}):\n{err}")
    try:
        if errors:
            raise RuntimeError("\n".join(errors))
        tmp = LIB_PATH.with_suffix(f".{tag}.so")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, LIB_PATH)
        write_stamp(LIB_PATH, _sources())
        PTXAS_REPORT.write_text("".join(reports))
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)


def _sources() -> list:
    return sorted(CSRC.iterdir())


def _stamp_text(sources) -> str:
    return "\n".join(p.name for p in sources)


def write_stamp(lib: Path, sources) -> None:
    """Record beside `lib` the names of the sources it was built from."""
    lib.with_suffix(".sources").write_text(_stamp_text(sources))


def stale(lib: Path, sources) -> bool:
    """Whether `lib` must be built from `sources`: it is missing, was built
    from another list of sources (a library that lacks a newer source's
    symbols can be newer than every source), or is older than one."""
    stamp = lib.with_suffix(".sources")
    if not lib.exists() or not stamp.exists() or stamp.read_text() != _stamp_text(sources):
        return True
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def load():
    """Build (if the library is missing, from other sources, or older than
    one of them) and load the kernels, as the span `build.load`, which
    counts whether nvcc ran."""
    global _lib, _entries
    lib = _lib
    if lib is not None:
        return lib
    with _lock, spans.span("build.load") as s:
        if _lib is not None:
            return _lib
        built = stale(LIB_PATH, _sources())
        s.count(nvcc=built)
        if built:
            _build()
        lib = ctypes.CDLL(str(LIB_PATH))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.webp_enc_resident.argtypes = [_I]
        lib.webp_enc_resident.restype = ctypes.c_int
        lib.webp_recon_filter_resident.argtypes = [_I, _I]
        lib.webp_recon_filter_resident.restype = ctypes.c_int
        lib.webp_coeff_tokens_resident.argtypes = []
        lib.webp_coeff_tokens_resident.restype = ctypes.c_int
        lib.webp_coeff_tokens_ring.argtypes = []
        lib.webp_coeff_tokens_ring.restype = ctypes.c_int
        lib.webp_vp8l_predictor_resident.argtypes = []
        lib.webp_vp8l_predictor_resident.restype = ctypes.c_int
        lib.webp_banded_max_clusters.argtypes = [_I, _I, _P]
        lib.webp_banded_max_clusters.restype = ctypes.c_int
        lib.webp_error_string.argtypes = [ctypes.c_int]
        lib.webp_error_string.restype = ctypes.c_char_p
        _entries = {name: getattr(lib, name) for name in _SIGNATURES}
        _lib = lib
        return lib


def launch(kernel: str, entry: str, device, *args) -> None:
    """Launch `entry` on `device`'s current stream; raise on a refused launch.

    Once the library is loaded a launch takes no lock: the bound entry
    point comes from a dict, the stream handle from PyTorch's raw
    current-stream query (what its own Triton launches use), and the
    device context is entered only when `device` is not the current one.
    """
    import torch

    fn = _entries.get(entry) if _lib is not None else None
    if fn is None:
        load()
        fn = _entries[entry]
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        msg = _lib.webp_error_string(rc).decode()
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc} ({msg})")
    LAUNCHES[kernel] += 1


def mb_field(t, batch: int, nmb: int, width: int = 1):
    """(pointer, batch stride) of a per-MB uint8/bool field [B, nmb(, width)].

    The field may be a strided view (a slice of the packed u8 buffer); its
    per-image data must be contiguous.
    """
    import torch

    want = (batch, nmb) if width == 1 else (batch, nmb, width)
    if t.dtype not in (torch.uint8, torch.bool) or tuple(t.shape) != want:
        raise ValueError(f"per-MB field must be uint8 {want}, got {t.dtype} {tuple(t.shape)}")
    inner = (1,) if width == 1 else (width, 1)
    if tuple(t.stride()[1:]) != inner:
        raise ValueError("per-MB field must be contiguous within each image")
    return t.data_ptr(), t.stride(0)


def dense(t, dtype, shape) -> int:
    """Pointer of a contiguous tensor of the given dtype and shape."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"expected contiguous {dtype} {tuple(shape)}, got {t.dtype} {tuple(t.shape)}"
        )
    return t.data_ptr()


def aligned(ptr: int, n: int, what: str) -> int:
    """`ptr`, checked to be a multiple of n (a kernel's vector loads)."""
    if ptr % n:
        raise ValueError(f"{what} must be {n}-byte aligned for the kernel, got {ptr:#x}")
    return ptr


def plane(t, batch: int, rows: int, cols: int):
    """(pointer, batch stride) of a uint8 plane [B, rows, cols] with packed rows."""
    import torch

    if t.dtype != torch.uint8 or tuple(t.shape) != (batch, rows, cols):
        raise ValueError(f"plane must be uint8 {(batch, rows, cols)}, got {t.dtype} {tuple(t.shape)}")
    if t.stride(2) != 1 or t.stride(1) != cols:
        raise ValueError("plane rows must be packed")
    return t.data_ptr(), t.stride(0)


_constants = {}


def device_constant(name: str, values, device):
    """A read-only int32 copy of the host table `values` on `device`, made once."""
    import numpy as np
    import torch

    key = (name, str(device))
    with _lock:
        t = _constants.get(key)
        if t is None:
            t = torch.from_numpy(np.ascontiguousarray(values, np.int32).reshape(-1)).to(device)
            _constants[key] = t
    return t


def upload(a, device):
    """The host numpy array `a` on `device`.  To a CUDA device it is staged in
    pinned memory and copied without blocking the host; PyTorch's caching
    host allocator keeps the staging buffer until the copy has run.  On the
    CPU, a tensor over `a` itself."""
    import numpy as np
    import torch

    t = torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def download(t):
    """Starts a copy of the tensor `t` to the host without blocking; returns
    wait() -> the numpy array.  From a CUDA device the copy goes to pinned
    memory on `t`'s current stream, and wait() waits for an event recorded
    after it (not for the stream's later work).  On the CPU, wait() returns
    `t`'s numpy view."""
    import torch

    if t.device.type == "cpu":
        return t.numpy
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))

    def wait():
        done.synchronize()
        return host.numpy()

    return wait


_scratch = {}


def kept_zeroed(name: str, numel: int, dtype, device):
    """A persistent buffer of at least `numel` elements, zero when made, for
    a kernel that leaves it zero when it ends (per-image sums and tickets
    that an image's last CTA reads and resets), so that a call needs no
    memset.  One per (name, device, current stream): calls on one stream
    run in order and so never share it in flight."""
    import torch

    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    key = (name, index, torch.cuda.current_stream(index).cuda_stream)
    with _lock:
        t = _scratch.get(key)
        if t is None or t.numel() < numel:
            t = torch.zeros(numel, dtype=dtype, device=torch.device("cuda", index))
            _scratch[key] = t
    return t


def table(t, batch: int, shape):
    """(pointer, batch stride) of an int32 per-image table [B, *shape]: each
    image's table contiguous, the batch stride 0 for one table shared by all."""
    import torch

    if t.dtype != torch.int32 or tuple(t.shape) != (batch, *shape):
        raise ValueError(f"table must be int32 {(batch, *shape)}, got {t.dtype} {tuple(t.shape)}")
    inner = t[0]
    if not inner.is_contiguous():
        raise ValueError("each image's table must be contiguous")
    return t.data_ptr(), t.stride(0)


def same_device(*tensors):
    """The one device all `tensors` lie on (raises if they differ)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    return dev

"""ctypes bindings for the host half of the decode: the C++ entropy pass.

The boolean arithmetic decoder is the codec's serial tail and runs on the
host.  Its source is the repo's `native/vp8_entropy.cpp`; this module builds
it with g++ at first use into `build/` beside the package (its own copy, so
that it never shares a library file with another process's build) and binds
the three entry points the decode needs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..common import vp8_tables as T

_ROOT = Path(__file__).resolve().parent.parent.parent
SRC = _ROOT / "native" / "vp8_entropy.cpp"
LIB_PATH = _ROOT / "build" / "libwebp_tpu_torch_native.so"

_lib = None
_lock = threading.Lock()

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i16p = ctypes.POINTER(ctypes.c_int16)
_i32p = ctypes.POINTER(ctypes.c_int32)

_DEFAULT_PROBS = np.ascontiguousarray(T.COEFF_PROBS_DEFAULT, dtype=np.uint8)
_UPDATE_PROBS = np.ascontiguousarray(T.COEFF_UPDATE_PROBS, dtype=np.uint8)
_BPRED_PROBS = np.ascontiguousarray(T.KEYFRAME_BPRED_MODE_PROBS, dtype=np.uint8)
_DC_Q = np.ascontiguousarray(T.DC_QUANT, dtype=np.int16)
_AC_Q = np.ascontiguousarray(T.AC_QUANT, dtype=np.int16)


def _build() -> None:
    # A temp file and an atomic rename, so that a concurrent first use never
    # loads a half-written library.
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)


def load():
    """Build (if the source is newer than the library) and load it."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not LIB_PATH.exists() or LIB_PATH.stat().st_mtime < SRC.stat().st_mtime:
            _build()
        lib = ctypes.CDLL(str(LIB_PATH))
        lib.vp8_parse_dims.restype = ctypes.c_int
        lib.vp8_parse_dims.argtypes = [_u8p, ctypes.c_int, _i32p, _i32p]
        lib.vp8_entropy_decode16.restype = ctypes.c_int
        lib.vp8_entropy_decode16.argtypes = [
            _u8p, ctypes.c_int, _u8p, _u8p, _u8p, _i16p, _i16p,
            _i32p, _i32p, _u8p, _u8p, _u8p, _u8p, _u8p, _u8p, _i16p,
        ]
        lib.yuv420_to_rgb_fancy.restype = ctypes.c_int
        lib.yuv420_to_rgb_fancy.argtypes = [
            _u8p, ctypes.c_int, _u8p, _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p,
        ]
        _lib = lib
        return lib


def _p(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def parse_dims(payload) -> tuple[int, int]:
    """(width, height) of a VP8 payload, from its frame header."""
    buf = np.frombuffer(bytes(payload), np.uint8)
    w, h = ctypes.c_int32(), ctypes.c_int32()
    rc = load().vp8_parse_dims(_p(buf, ctypes.c_uint8), len(buf), ctypes.byref(w),
                               ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"vp8_parse_dims failed: {rc}")
    return w.value, h.value


def entropy_decode16_into(data, header, seg, luma_mode, chroma_mode, segment_ids, bpred,
                          skipped, non_zero, levels) -> None:
    """Levels-mode entropy pass of one VP8 keyframe into caller arrays.

    header int32 [16] and seg int32 [4*8] receive the frame and segment
    headers; the per-MB mode arrays are uint8 (bpred [nmb*16]); levels is
    int16 [nmb*25*16], the raw quantizer levels (block 24 = Y2).  Every
    array must be a C-contiguous, zero-filled view: only nonzero values are
    written.
    """
    buf = np.frombuffer(bytes(data), np.uint8)
    rc = load().vp8_entropy_decode16(
        _p(buf, ctypes.c_uint8), len(buf),
        _p(_DEFAULT_PROBS, ctypes.c_uint8), _p(_UPDATE_PROBS, ctypes.c_uint8),
        _p(_BPRED_PROBS, ctypes.c_uint8), _p(_DC_Q, ctypes.c_int16), _p(_AC_Q, ctypes.c_int16),
        _p(header, ctypes.c_int32), _p(seg, ctypes.c_int32),
        _p(luma_mode, ctypes.c_uint8), _p(chroma_mode, ctypes.c_uint8),
        _p(segment_ids, ctypes.c_uint8), _p(bpred, ctypes.c_uint8),
        _p(skipped, ctypes.c_uint8), _p(non_zero, ctypes.c_uint8),
        _p(levels, ctypes.c_int16),
    )
    if rc != 0:
        raise ValueError(f"vp8_entropy_decode16 failed: {rc}")


def yuv420_to_rgb_fancy(ybuf: np.ndarray, ubuf: np.ndarray, vbuf: np.ndarray,
                        width: int, height: int) -> np.ndarray:
    """Fancy-upsampled YUV420 planes -> RGB [height, width, 3] uint8 on the
    host (the same arithmetic as kernel K4)."""
    ybuf, ubuf, vbuf = (np.ascontiguousarray(p, np.uint8) for p in (ybuf, ubuf, vbuf))
    rgb = np.empty((height, width, 3), np.uint8)
    rc = load().yuv420_to_rgb_fancy(
        _p(ybuf, ctypes.c_uint8), ybuf.shape[1],
        _p(ubuf, ctypes.c_uint8), _p(vbuf, ctypes.c_uint8), ubuf.shape[1],
        width, height, _p(rgb, ctypes.c_uint8),
    )
    if rc != 0:
        raise ValueError(f"yuv420_to_rgb_fancy failed: {rc}")
    return rgb

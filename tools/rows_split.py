#!/usr/bin/env python3
"""Time the decode's row-pipeline kernels on one NVIDIA GPU, and where an
MB's time goes: K2 recon, K3 loopfilter and their fusion recon_filter
(`webp_tpu_torch/csrc/wavefront_rows.cu`, a row a CTA), and the banded K16
recon_banded and K17 filter_banded (`csrc/banded.cu`, a band a CTA of a
cluster, its rows as row pipelines of one warp) at 1, 2, 4 and 8 bands.

    python3 tools/rows_split.py [--csrc DIR] [--probe] [--out FILE]

Inputs are `chip_smoke.py`'s decode batch: two seeded 768x512 random
keyframes with the normal loop filter tiled to 8, parsed on the host, K1's
residuals on the card.  The script copies the package's kernel sources
into `build/rows_split/package/`, builds them there with nvcc, and reports
each kernel's time (CUDA events, the median of ten launches through the
C entry points, the scratch allocated as the wrappers do; the filters on
fresh unfiltered planes), its time per wavefront step, K2's and K3's
resident row CTAs, the banded kernels' CTA shape and chain floor (T
hand-overs, timed on rings of row pipelines inside a CTA and across a
cluster), and ptxas's registers and spills, with the card's name and power
limit.

--csrc DIR also builds DIR (an earlier commit's `webp_tpu_torch/csrc`, from
`git archive <commit> webp_tpu_torch/csrc` unpacked under `build/`) into
`build/rows_split/parent/` and times its K2, K3, fused kernel, K16 and K17
in the same process, in turns with the package's (parent, package,
package, parent), on the same inputs.  DIR's `webp_recon_banded` must take
no edge scratch (the cluster-barrier kernels of commit dda5a8e and
before).

--probe inserts `clock64()` probes into the package's copy of
`rows_mb.cuh` (`run_row`): per row, thread 0 of its team sums over the
row's iterations the cycles of the wait for the row above, the team
barrier after it, the loads, the compute phase, the stores and the
publish (K2's and K16's plane stores after the publish fall into the
next iteration's wait); reported as mean cycles per MB over the rows, with the banded
kernels' wait split into rows inside a band and a band's first row (its
counter read from the CTA above), and the probes' cost in the kernels'
times.  The probes are text patches at anchors of the source; the script
stops at the first anchor that is not found exactly once.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("wait", "barrier", "loads", "compute", "stores", "publish")
N_ACC = len(PHASES) + 1  # the phases, then the row's MBs
MAX_ROWS = 4096
N_BANDS = (1, 2, 4, 8)
PARENT_BANDS = (2, 4, 8)

PROBE_DECL = f"""
constexpr int kProbeAcc = {N_ACC};
static __device__ long long rows_probe[{MAX_ROWS} * kProbeAcc];
#define PROBE(k) do {{ if (tid == 0) {{ const long long t_ = clock64(); acc[k] += t_ - tp; tp = t_; }} }} while (0)
"""

PROBE_API = """
WEBP_API int webp_{name}_probe(void* host, int n) {{
    cudaError_t err = cudaMemcpyFromSymbol(host, rows_probe, n * sizeof(long long));
    if (err != cudaSuccess) return static_cast<int>(err);
    static long long zeros[sizeof(rows_probe) / sizeof(long long)];
    return static_cast<int>(cudaMemcpyToSymbol(rows_probe, zeros, sizeof(zeros)));
}}
"""
PROBE_FILES = {"wavefront_rows.cu": "rows", "banded.cu": "band"}  # source -> its probe reader

# (anchor, replacement): each anchor must occur exactly once in rows_mb.cuh.
PATCHES = [
    ('#include "filter_mb.cuh"\n', '#include "filter_mb.cuh"\n' + PROBE_DECL),
    ("    for (int i = 0; i < n_iter; ++i) {\n",
     "    long long acc[kProbeAcc] = {};\n    long long tp = clock64();\n"
     "    for (int i = 0; i < n_iter; ++i) {\n"),
    ("link.wait(min(i + 2, n_iter));\n        link.sync();\n",
     "link.wait(min(i + 2, n_iter));\n        PROBE(0);\n        link.sync();\n        PROBE(1);\n"),
    ("        link.sync();\n\n        // 2. Recon of MB i",
     "        link.sync();\n        PROBE(2);\n\n        // 2. Recon of MB i"),
    ("        link.sync();\n\n        // 3. Stores:",
     "        link.sync();\n        PROBE(3);\n\n        // 3. Stores:"),
    ("        link.sync();\n        if (tid == 0) link.publish(i + 1);\n",
     "        link.sync();\n        PROBE(4);\n        if (tid == 0) link.publish(i + 1);\n"
     "        PROBE(5);\n"),
    ("    }\n}\n\n}  // namespace\n",
     "    }\n"
     "    if (tid == 0) {\n"
     "        long long* out = rows_probe + (static_cast<long long>(b) * a.mbh + r) * kProbeAcc;\n"
     "        for (int k = 0; k < kProbeAcc - 1; ++k) out[k] = acc[k];\n"
     "        out[kProbeAcc - 1] = n_iter;\n"
     "    }\n}\n\n}  // namespace\n"),
]
PTXAS_NAMES = {"rows_kernelILb1ELb0E": "recon", "rows_kernelILb0ELb1E": "loopfilter",
               "rows_kernelILb1ELb1E": "recon_filter", "banded_kernelILb1ELb0E": "recon_banded",
               "banded_kernelILb0ELb1E": "filter_banded", "band_handoff_kernel": "band_handoff"}
ROW_KERNELS = {"recon": (True, False), "loopfilter": (False, True), "recon_filter": (True, True)}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
PARENT_SIGNATURES = {  # the cluster-barrier kernels' entry points (no edge scratch)
    "webp_recon_banded": [_P, _P, _L, _P, _L, _P, _L, _I, _I, _I, _I, _P, _L, _P, _L, _P, _L, _P],
    "webp_filter_banded": [_P, _L, _P, _L, _P, _L, _P, _L, _P, _L, _P, _L, _P, _L,
                           _I, _I, _I, _I, _I, _P],
}


def instrument(src: str) -> str:
    for anchor, replacement in PATCHES:
        n = src.count(anchor)
        if n != 1:
            raise SystemExit(f"probe anchor found {n} times, not once: {anchor[:60]!r}")
        src = src.replace(anchor, replacement)
    return src


def ptxas_lines(report: Path) -> list:
    out, name = [], None
    for line in report.read_text().splitlines():
        if "Compiling entry function" in line:
            name = next((v for k, v in PTXAS_NAMES.items() if k in line), None)
        elif name and ("spill" in line or "registers" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def build(_build, csrc: Path, work: Path, probe: bool = False, bind: bool = True):
    """Copy `csrc` into `work`, patch it for the probes, build it, and load
    it: through `_build.load` (which binds the package's entry points), or
    with ctypes alone."""
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(csrc, work / "csrc")
    if probe:
        path = work / "csrc" / "rows_mb.cuh"
        path.write_text(instrument(path.read_text()))
        for f, name in PROBE_FILES.items():
            path = work / "csrc" / f
            path.write_text(path.read_text() + PROBE_API.format(name=name))
    _build.CSRC, _build.BUILD_DIR = work / "csrc", work
    _build.LIB_PATH = work / "librows_split.so"
    _build.PTXAS_REPORT = work / "ptxas.txt"
    _build._lib = None
    if bind:
        return _build.load()
    _build._build()
    return ctypes.CDLL(str(_build.LIB_PATH))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, help="an earlier csrc whose K16 / K17 to time beside")
    ap.add_argument("--probe", action="store_true", help="clock64() probes per MB phase")
    ap.add_argument("--out", type=Path, help="also write the numbers to this JSON file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("rows_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import chip_smoke
    from webp_tpu_torch import _build
    from webp_tpu_torch.decode import device as tdev
    from webp_tpu_torch.ops import banded
    from webp_tpu_torch.ops.recon_filter import resident_rows
    from webp_tpu_torch.ops.wavefront import recon_, row_scratch

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    package_csrc = _build.CSRC
    parent = None
    if args.csrc:
        parent = build(_build, args.csrc, ROOT / "build" / "rows_split" / "parent", bind=False)
        for name in ("webp_recon", "webp_loopfilter", "webp_recon_filter", *PARENT_SIGNATURES):
            getattr(parent, name).argtypes = PARENT_SIGNATURES.get(name, _build._SIGNATURES[name])
            getattr(parent, name).restype = ctypes.c_int
    lib = build(_build, package_csrc, ROOT / "build" / "rows_split" / "package", args.probe)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"

    payloads = [p for p, _, _ in chip_smoke.make_payloads(768, 512, simple=False)]
    batch = [payloads[i % len(payloads)] for i in range(8)]
    d = tdev.to_device_batch(tdev.parse_levels_batch(batch), dev)
    mbw, mbh = tdev.geometry(d["headers"])[:2]
    res, lm, bp, cm, level, interior, hev, do_sub = tdev.wavefront_inputs(d)
    recon_args, lf_args = (res, lm, bp, cm), (level, interior, hev, do_sub)
    steps = mbw + 2 * (mbh - 1)
    nmb = mbw * mbh

    def planes():
        return tdev.split_planes(torch.zeros((8, nmb * 384), dtype=torch.uint8, device=dev),
                                 mbw, mbh)

    target, rec = planes(), planes()
    recon_(*rec, *recon_args)
    filt = [p.clone() for p in rec]

    def fresh():
        for w, r in zip(filt, rec):
            w.copy_(r)

    rec_ptrs = [_build.dense(res, torch.int32, (8, nmb, 24, 16)), *_build.mb_field(lm, 8, nmb),
                *_build.mb_field(bp, 8, nmb, 16), *_build.mb_field(cm, 8, nmb)]
    lf_ptrs = [x for f in lf_args for x in _build.mb_field(f, 8, nmb)]

    def plane_ptrs(ps):
        return [*_build.plane(ps[0], 8, mbh * 16, mbw * 16), *_build.plane(ps[1], 8, mbh * 8, mbw * 8),
                *_build.plane(ps[2], 8, mbh * 8, mbw * 8)]

    def direct(lib_, kernel: str, n_band: int, new: bool):
        """One launch of `kernel` from `lib_` (the package's, `new`, or the
        parent's), its scratch allocated as the wrappers do; both builds go
        through this one path, so that their host work matches."""
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kernel == "recon_banded":
            edge = [torch.empty((8, mbh, 32 * mbw), dtype=torch.uint8, device=dev).data_ptr()]
            rc = lib_.webp_recon_banded(*rec_ptrs, mbw, mbh, 8, n_band, *plane_ptrs(target),
                                        *(edge if new else []), stream)
        elif kernel == "filter_banded":
            rc = lib_.webp_filter_banded(*plane_ptrs(filt), *lf_ptrs, mbw, mbh, 8, 0, n_band,
                                         stream)
        else:
            edge, prog = row_scratch(8, mbh, mbw, dev, edge=kernel != "loopfilter")
            if kernel == "recon":
                rc = lib_.webp_recon(*rec_ptrs, mbw, mbh, 8, *plane_ptrs(target), edge.data_ptr(),
                                     prog.data_ptr(), stream)
            elif kernel == "loopfilter":
                rc = lib_.webp_loopfilter(*plane_ptrs(filt), *lf_ptrs, mbw, mbh, 8, 0,
                                          prog.data_ptr(), stream)
            else:
                rc = lib_.webp_recon_filter(*rec_ptrs, *lf_ptrs, mbw, mbh, 8, 0,
                                            *plane_ptrs(target), edge.data_ptr(), prog.data_ptr(),
                                            stream)
        if rc != 0:
            raise RuntimeError(f"{kernel} launch failed: CUDA error {rc}")

    names = ["recon", "loopfilter", "recon_filter"] + [
        f"{k}/{n}" for n in N_BANDS for k in ("recon_banded", "filter_banded")]
    setup = {name: fresh for name in names if "filter" in name and name != "recon_filter"}
    inside_ms, across_ms = chip_smoke.band_handoff_ms(dev)
    out = {"card": card, "csrc": str(args.csrc), "probe": args.probe,
           "ptxas": ptxas_lines(_build.PTXAS_REPORT), "steps": steps,
           "handoff_us": {"inside": inside_ms * 1e3, "across": across_ms * 1e3,
                          "global": chip_smoke.handoff_ms(dev) * 1e3},
           "kernels": {}}
    print(f"hand-overs: inside a band {inside_ms * 1e3:.4f} us, across bands "
          f"{across_ms * 1e3:.4f} us, between row CTAs {out['handoff_us']['global']:.4f} us "
          f"({card})", flush=True)
    n_rows = 8 * mbh
    if args.probe:
        for name in PROBE_FILES.values():
            getattr(lib, f"webp_{name}_probe").argtypes = [ctypes.c_void_p, ctypes.c_int]
            getattr(lib, f"webp_{name}_probe").restype = ctypes.c_int
    for name in names:
        kernel, _, bands = name.partition("/")
        n_band = int(bands) if bands else 0
        rec_ = {}
        if parent is not None and (not n_band or n_band in PARENT_BANDS):
            order = ("parent", "package", "package", "parent")
        else:
            order = ("package",)
        for who in order:
            def go():
                direct(lib if who == "package" else parent, kernel, n_band, who == "package")

            ms = [chip_smoke.time_ms(go, 1, setup.get(name)) for _ in range(10)]
            rec_.setdefault(who, []).append(statistics.median(ms))
        rec_["ms"] = statistics.median(rec_["package"])
        rec_["us_per_step"] = rec_["ms"] / steps * 1e3
        if n_band:
            shape = banded.max_active_clusters(n_band, mbh)
            rec_["shape"] = shape._asdict()
            rec_["chain_floor_ms"] = chip_smoke.band_floor_ms(steps, n_band, inside_ms, across_ms)
        else:
            rec_["resident"] = resident_rows(dev, *ROW_KERNELS[kernel])
        if args.probe:
            read = getattr(lib, "webp_band_probe" if n_band else "webp_rows_probe")
            buf = (ctypes.c_longlong * (n_rows * N_ACC))()
            read(buf, n_rows * N_ACC)  # read and zero
            if name in setup:
                setup[name]()
            direct(lib, kernel, n_band, True)
            torch.cuda.synchronize()
            if read(buf, n_rows * N_ACC) != 0:
                raise RuntimeError("the probe read failed")
            rows = [(i % mbh, buf[i * N_ACC:(i + 1) * N_ACC]) for i in range(n_rows)]
            cyc = {ph: statistics.mean(r[k] / r[N_ACC - 1] for _, r in rows)
                   for k, ph in enumerate(PHASES)}
            cyc["total"] = sum(cyc.values())
            if n_band:
                r_loc = mbh // n_band
                waits = {"inside": [r[0] / r[N_ACC - 1] for y, r in rows if y % r_loc],
                         "across": [r[0] / r[N_ACC - 1] for y, r in rows if y and not y % r_loc]}
                cyc.update({f"wait_{k}": statistics.mean(v) for k, v in waits.items() if v})
            rec_["cycles_per_mb"] = cyc
        out["kernels"][name] = rec_
        extra = ""
        if "parent" in rec_:
            extra += f"; parent {' / '.join(f'{t:.4f}' for t in rec_['parent'])} ms"
        if n_band:
            extra += f"; {rec_['shape']}; chain floor {rec_['chain_floor_ms']:.4f} ms"
        else:
            extra += f"; resident row CTAs {rec_['resident']}"
        if args.probe:
            extra += f"; cycles per MB {({k: round(v) for k, v in rec_['cycles_per_mb'].items()})}"
        print(f"{name}: {rec_['ms']:.4f} ms ({' / '.join(f'{t:.4f}' for t in rec_['package'])}; "
              f"{rec_['us_per_step']:.2f} us a step, T = {steps}){extra} ({card})", flush=True)
    for line in out["ptxas"]:
        print(f"ptxas {line}")
    print(smi)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

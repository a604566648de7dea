#!/usr/bin/env python3
"""Time the row-CTA kernels of `webp_tpu_torch/csrc/wavefront_rows.cu` (K2
recon, K3 loopfilter and their fusion recon_filter), and where an MB's
time goes, on one NVIDIA GPU.

    python3 tools/rows_split.py [--csrc DIR] [--probe] [--out FILE]

Inputs are `chip_smoke.py`'s decode batch: two seeded 768x512 random
keyframes with the normal loop filter tiled to 8, parsed on the host, K1's
residuals on the card.  The script copies the kernel sources (the
package's, or DIR's, e.g. `git archive <commit> webp_tpu_torch/csrc`
unpacked under `build/`) into `build/rows_split/`, builds them there with
nvcc, and reports each instance's time (CUDA events, the median of ten
launches; the filter on fresh unfiltered planes), its time per wavefront
step, its resident row CTAs (the occupancy API) and ptxas's registers and
spills, with the card's name and power limit.

--probe inserts `clock64()` probes into the copy of `wavefront_rows.cu`:
per row CTA, cycles summed over its iterations of the wait for the row
above, the barrier after it, the loads, the compute phase (recon of MB i
beside the filter of MB i - 1 in the fused kernel) with, inside it,
thread 0's recon and the filter warp's filter, the stores, and the fence
+ release; reported as mean cycles per iteration over the CTAs, with the
probes' cost in the kernels' times.  The probes are text patches at
anchors of the source; the script stops at the first anchor that is not
found exactly once.
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
PHASES = ("wait", "barrier", "loads", "recon_own", "filter_own", "compute", "stores", "release")
IN_COMPUTE = ("recon_own", "filter_own")  # parts of "compute", left out of the total
N_ACC = len(PHASES) + 1  # the phases, then the CTA's MBs
MAX_ROWS = 4096

PROBE_DECL = f"""
constexpr int kProbeAcc = {N_ACC};
__device__ long long rows_probe[{MAX_ROWS} * kProbeAcc];
#define PROBE(k) do {{ if (tid == 0) {{ const long long t_ = clock64(); acc[k] += t_ - tp; tp = t_; }} }} while (0)
"""

PROBE_API = f"""
WEBP_API int webp_rows_probe(void* host, int n) {{
    cudaError_t err = cudaMemcpyFromSymbol(host, rows_probe, n * sizeof(long long));
    if (err != cudaSuccess) return static_cast<int>(err);
    static long long zeros[{MAX_ROWS} * kProbeAcc];
    return static_cast<int>(cudaMemcpyToSymbol(rows_probe, zeros, sizeof(zeros)));
}}
"""

# (anchor, replacement): each anchor must occur exactly once in wavefront_rows.cu.
# Thread 0 times the phases between the CTA's barriers (its own recon share
# of the compute phase too); lane 0 of the filter warp times its filter.
PATCHES = [
    ('#include "filter_mb.cuh"\n', '#include "filter_mb.cuh"\n' + PROBE_DECL),
    ("    for (int i = 0; i < n_iter; ++i) {\n",
     "    long long acc[kProbeAcc] = {};\n    long long tp = clock64();\n"
     "    for (int i = 0; i < n_iter; ++i) {\n"),
    ("__nanosleep(32);\n        }\n        __syncthreads();\n",
     "__nanosleep(32);\n        }\n        PROBE(0);\n        __syncthreads();\n        PROBE(1);\n"),
    ("        __syncthreads();\n\n        // 2. Recon of MB i",
     "        __syncthreads();\n        PROBE(2);\n\n        // 2. Recon of MB i"),
    ("        const int lvl = filt ? a.level[b * a.lv_bs + mf] : 0;\n",
     "        if (tid == 0) acc[3] += clock64() - tp;\n"
     "        const int lvl = filt ? a.level[b * a.lv_bs + mf] : 0;\n"
     "        const long long tf = clock64();\n"),
    ("&tc[0][0][0], &tc[1][0][0]);\n",
     "&tc[0][0][0], &tc[1][0][0]);\n"
     "        if (tid == kFilterWarp * 32) acc[4] += clock64() - tf;\n"),
    ("        __syncthreads();\n\n        // 3. Stores:",
     "        __syncthreads();\n        PROBE(5);\n\n        // 3. Stores:"),
    ("        __syncthreads();\n        if (tid == 0) {\n            __threadfence();\n"
     "            st_release(a.prog + static_cast<long long>(b) * a.mbh + r, i + 1);\n"
     "        }\n    }\n}\n",
     "        __syncthreads();\n        PROBE(6);\n        if (tid == 0) {\n"
     "            __threadfence();\n"
     "            st_release(a.prog + static_cast<long long>(b) * a.mbh + r, i + 1);\n"
     "        }\n        PROBE(7);\n    }\n"
     "    long long* out = rows_probe + S.row * kProbeAcc;\n"
     "    if (tid == kFilterWarp * 32) out[4] = acc[4];\n"
     "    if (tid == 0) {\n"
     "        for (int k = 0; k < kProbeAcc - 1; ++k) if (k != 4) out[k] = acc[k];\n"
     "        out[kProbeAcc - 1] = mbw;\n"
     "    }\n}\n"),
]
KERNELS = {"recon": (True, False), "loopfilter": (False, True), "recon_filter": (True, True)}
PTXAS_NAMES = {"rows_kernelILb1ELb0E": "recon", "rows_kernelILb0ELb1E": "loopfilter",
               "rows_kernelILb1ELb1E": "recon_filter"}


def instrument(src: str) -> str:
    for anchor, replacement in PATCHES:
        n = src.count(anchor)
        if n != 1:
            raise SystemExit(f"probe anchor found {n} times, not once: {anchor[:60]!r}")
        src = src.replace(anchor, replacement)
    return src + PROBE_API


def ptxas_lines(report: Path) -> list:
    out, name = [], None
    for line in report.read_text().splitlines():
        if "Compiling entry function" in line:
            name = next((v for k, v in PTXAS_NAMES.items() if k in line), None)
        elif name and ("spill" in line or "registers" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, help="kernel sources to build instead of the package's")
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
    from webp_tpu_torch.ops.loopfilter import loop_filter_
    from webp_tpu_torch.ops.recon_filter import recon_filter_, resident_rows
    from webp_tpu_torch.ops.wavefront import recon_

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    work = ROOT / "build" / "rows_split"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(_build.CSRC, work / "csrc")
    if args.csrc:
        for f in args.csrc.iterdir():
            shutil.copy(f, work / "csrc" / f.name)
    if args.probe:
        path = work / "csrc" / "wavefront_rows.cu"
        path.write_text(instrument(path.read_text()))
    _build.CSRC, _build.BUILD_DIR = work / "csrc", work
    _build.LIB_PATH = work / "librows_split.so"
    _build.PTXAS_REPORT = work / "ptxas.txt"
    lib = _build.load()

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

    def planes():
        return tdev.split_planes(torch.zeros((8, mbw * mbh * 384), dtype=torch.uint8,
                                             device=dev), mbw, mbh)

    target, rec = planes(), planes()
    recon_(*rec, *recon_args)
    filt = [p.clone() for p in rec]

    def fresh():
        for w, r in zip(filt, rec):
            w.copy_(r)

    run = {"recon": lambda: recon_(*target, *recon_args),
           "loopfilter": lambda: loop_filter_(*filt, *lf_args, False),
           "recon_filter": lambda: recon_filter_(*target, *recon_args, *lf_args, False)}
    setup = {"loopfilter": fresh}
    out = {"card": card, "csrc": str(args.csrc or "package"), "probe": args.probe,
           "ptxas": ptxas_lines(_build.PTXAS_REPORT), "kernels": {}}
    n_rows = 8 * mbh
    if args.probe:
        lib.webp_rows_probe.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.webp_rows_probe.restype = ctypes.c_int
    for name, fn in run.items():
        ms = [chip_smoke.time_ms(fn, 1, setup.get(name)) for _ in range(10)]
        rec_ = {"ms": statistics.median(ms), "ms_all": ms,
                "us_per_step": statistics.median(ms) / steps * 1e3,
                "resident": resident_rows(dev, *KERNELS[name])}
        if args.probe:
            buf = (ctypes.c_longlong * (n_rows * N_ACC))()
            lib.webp_rows_probe(buf, n_rows * N_ACC)  # read and zero
            if name in setup:
                setup[name]()
            fn()
            torch.cuda.synchronize()
            if lib.webp_rows_probe(buf, n_rows * N_ACC) != 0:
                raise RuntimeError("webp_rows_probe failed")
            rows = [buf[i * N_ACC:(i + 1) * N_ACC] for i in range(n_rows)]
            cyc = {ph: statistics.mean(r[k] / r[N_ACC - 1] for r in rows)
                   for k, ph in enumerate(PHASES)}
            cyc["total"] = sum(v for k, v in cyc.items() if k not in IN_COMPUTE)
            rec_["cycles_per_mb"] = cyc
        out["kernels"][name] = rec_
        print(f"{name}: {rec_['ms']:.4f} ms ({rec_['us_per_step']:.2f} us a step, T = {steps}); "
              f"resident row CTAs {rec_['resident']}; "
              + (f"cycles per MB {({k: round(v) for k, v in rec_['cycles_per_mb'].items()})}; "
                 if args.probe else "") + f"({card})", flush=True)
    for line in out["ptxas"]:
        print(f"ptxas {line}")
    print(smi)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

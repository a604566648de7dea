#!/usr/bin/env python3
"""Where a step of kernel K5 (`webp_tpu_torch/csrc/enc.cu`) spends its time,
on one NVIDIA GPU.

    python3 tools/k5_split.py --old-csrc DIR [--out FILE]
    python3 tools/k5_split.py --probe [--out FILE]
    python3 tools/k5_split.py [--out FILE]

Each runs the flagship encode of `chip_smoke.py` (two synthetic 768x512
frames tiled to 8, Q75 m4, segments on, two-pass, 8 partitions) three
times through `encode_frames_lossy_batch` and reports K5's two launches
(pass 1 and pass 2) of the last two runs; it prints them, with the card's
name and power limit, and writes them to --out when given.

--old-csrc: the one-block-per-image K5 of commit 55c6fa2 (one warp per MB
row, a block barrier per anti-diagonal), whose `enc.cu`, `common.cuh` and
`trellis.cuh` DIR holds: `git archive 55c6fa2 webp_tpu_torch/csrc | tar -x
-C build/k5_parent` gives DIR = build/k5_parent/webp_tpu_torch/csrc.  The
script copies the package's kernel sources into `build/k5_split/`,
overlays DIR's three files, inserts `clock64()` probes into `enc.cu`
around each phase of an MB (I16 search, I4 search, the I4 commit with its
trellis, the I16 commit with its trellis, UV) and around the block
barrier, and builds every kernel from the copy with nvcc.  Per image and
warp it reads the cycles of each phase summed over its MBs, the cycles at
the barrier and the cycles from the kernel's start to its end, and
reports the kernel's time (CUDA events, the probes' cost included),
cycles per step and each phase's mean cycles per MB.

--probe: the package's own K5 (one CTA of four warps per (image, MB row))
with probes inserted the same way: per CTA, cycles summed over its MBs of
the wait for the row above, the edge loads, each warp's work (the
four-lane I4 search also split into its ten predictions, ranking,
candidates and pick; the trellis warp's wait for the search), each warp's
wait at the barrier after them, and the decision's writes and release.
The probes are text patches at anchors of the sources they were written
for; the script stops at the first anchor that is not found exactly once.

Neither: the package's own K5, untouched: each launch's time (CUDA
events, the median of five), its resident row CTAs (the occupancy API)
and ptxas's spill lines.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("i16_search", "i4_search", "i4_commit", "i16_commit", "uv")
N_ACC = 10  # the phases, MBs, I4 MBs, barrier cycles, then elapsed cycles

PROBE_DECL = """
constexpr int kProbeImages = 64;
constexpr int kProbeWarps = 32;
constexpr int kProbeAcc = 10;
__device__ long long k5_probe[kProbeImages * kProbeWarps * kProbeAcc];
"""

PROBE_API = """
WEBP_API int webp_k5_probe(void* host, int n) {
    cudaError_t err = cudaMemcpyFromSymbol(host, k5_probe, n * sizeof(long long));
    if (err != cudaSuccess) return static_cast<int>(err);
    static long long zeros[kProbeImages * kProbeWarps * kProbeAcc];
    return static_cast<int>(cudaMemcpyToSymbol(k5_probe, zeros, sizeof(zeros)));
}
"""

# (anchor, replacement): each anchor must occur exactly once in enc.cu.
PATCHES = [
    ('#include "trellis.cuh"\n', '#include "trellis.cuh"\n' + PROBE_DECL),
    ("    const int T_ = wavefront_steps(mbw, mbh);\n",
     "    const int T_ = wavefront_steps(mbw, mbh);\n"
     "    long long acc[kProbeAcc] = {};\n"
     "    const long long t_begin = clock64();\n"
     "    long long tk = 0;\n"),
    ("            int i16_score;\n",
     "            int i16_score;\n"
     "            tk = clock64();\n"
     "            acc[5] += 1;\n"),
    ("            bool use_i4 = false;\n",
     "            acc[0] += clock64() - tk;\n"
     "            tk = clock64();\n"
     "            bool use_i4 = false;\n"),
    ("            if (use_i4) {\n                if (kTrellis) {\n",
     "            acc[1] += clock64() - tk;\n"
     "            tk = clock64();\n"
     "            acc[6] += use_i4;\n"
     "            if (use_i4) {\n                if (kTrellis) {\n"),
    ("            const int uv = uv_search(",
     "            acc[use_i4 ? 2 : 3] += clock64() - tk;\n"
     "            tk = clock64();\n"
     "            const int uv = uv_search("),
    ("            if (lane == 0) cmode[m] = static_cast<uint8_t>(uv);\n",
     "            if (lane == 0) cmode[m] = static_cast<uint8_t>(uv);\n"
     "            acc[4] += clock64() - tk;\n"),
    ("        __syncthreads();\n    }\n}\n",
     "        tk = clock64();\n"
     "        __syncthreads();\n"
     "        acc[7] += clock64() - tk;\n"
     "    }\n"
     "    if (lane == 0 && b < kProbeImages) {\n"
     "        long long* o = k5_probe + (static_cast<long long>(b) * kProbeWarps + warp) * kProbeAcc;\n"
     "        for (int k = 0; k < 8; ++k) o[k] = acc[k];\n"
     "        o[9] = clock64() - t_begin;\n"
     "    }\n"
     "}\n"),
]


# The row-CTA K5: per CTA (blockIdx.x) and slot, cycles summed over its MBs
# by atomics of one lane.
ROW_SLOTS = ("spin", "i16_search", "i16_search_commit", "i4_search", "trellis", "uv",
             "unused6", "final", "edges", "mbs", "i4_mbs", "elapsed",
             "i4_predict_sse", "i4_rank", "i4_candidates", "i4_pick",
             "barrier_w0", "barrier_w1", "barrier_w2", "barrier_w3", "trellis_wait")
ROW_DECL = """
constexpr int kProbeAcc = 24;
__device__ unsigned long long k5_probe[8192 * kProbeAcc];
#define P_ADD(j, v) atomicAdd(k5_probe + blockIdx.x * kProbeAcc + (j), \
                              static_cast<unsigned long long>(v))
"""
ROW_API = """
WEBP_API int webp_k5_probe(void* host, int n) {
    cudaError_t err = cudaMemcpyFromSymbol(host, k5_probe, n * sizeof(long long));
    if (err != cudaSuccess) return static_cast<int>(err);
    static unsigned long long zeros[8192 * kProbeAcc];
    return static_cast<int>(cudaMemcpyToSymbol(k5_probe, zeros, sizeof(zeros)));
}
"""
ROW_PATCHES = [
    ('#include "trellis.cuh"\n', '#include "trellis.cuh"\n' + ROW_DECL),
    ("        int e[13], src[16];\n",
     "        long long q0 = clock64(), q1;\n"
     "        int e[13], src[16];\n"),
    ("        __syncwarp();\n        // Candidates in rank order",
     "        __syncwarp();\n"
     "        q1 = clock64();\n"
     "        if (lane == 0) P_ADD(12, q1 - q0);\n"
     "        q0 = q1;\n"
     "        // Candidates in rank order"),
    ("        int best = 0x7fffffff;\n",
     "        q1 = clock64();\n"
     "        if (lane == 0) P_ADD(13, q1 - q0);\n"
     "        q0 = q1;\n"
     "        int best = 0x7fffffff;\n"),
    ("            const int k = warp_argmin(score, lane, 16);\n",
     "            q1 = clock64();\n"
     "            if (lane == 0) P_ADD(14, q1 - q0);\n"
     "            q0 = q1;\n"
     "            const int k = warp_argmin(score, lane, 16);\n"),
    ("            best = min(best, k_score);\n            __syncwarp();\n",
     "            best = min(best, k_score);\n            __syncwarp();\n"
     "            q1 = clock64();\n"
     "            if (lane == 0) P_ADD(15, q1 - q0);\n"
     "            q0 = q1;\n"),
    ("        while (*reinterpret_cast<volatile int*>(&w.done) <= s) {\n        }\n",
     "        const long long q0 = clock64();\n"
     "        while (*reinterpret_cast<volatile int*>(&w.done) <= s) {\n        }\n"
     "        if (lane == 0) P_ADD(20, clock64() - q0);\n"),
    ("    for (int x = 0; x < mbw; ++x) {\n        if (tid == 0 && r > 0) {",
     "    const long long t_begin = clock64();\n"
     "    for (int x = 0; x < mbw; ++x) {\n"
     "        long long tk = clock64();\n"
     "        if (tid == 0 && r > 0) {"),
    ("            while (ld_acquire(done_above) < need) __nanosleep(32);\n        }\n        __syncthreads();\n",
     "            while (ld_acquire(done_above) < need) __nanosleep(32);\n        }\n        __syncthreads();\n"
     "        if (tid == 0) P_ADD(0, clock64() - tk);\n"
     "        tk = clock64();\n"),
    ("        __syncthreads();\n\n        Mb mb;\n",
     "        __syncthreads();\n"
     "        if (tid == 0) P_ADD(8, clock64() - tk);\n"
     "        tk = clock64();\n\n        Mb mb;\n"),
    ("            const int best = i16_search(mb, lane, T, E, S.a, &score);\n",
     "            const int best = i16_search(mb, lane, T, E, S.a, &score);\n"
     "            if (lane == 0) P_ADD(1, clock64() - tk);\n"),
    ("            const unsigned nz = i16_commit<kTrellis>(mb, lane, best, T, E, S.a);\n",
     "            const unsigned nz = i16_commit<kTrellis>(mb, lane, best, T, E, S.a);\n"
     "            if (lane == 0) P_ADD(2, clock64() - tk);\n"),
    ("            if (n_try > 0) i4_search(mb, lane, n_try, T, E, S.b);\n",
     "            if (n_try > 0) i4_search(mb, lane, n_try, T, E, S.b);\n"
     "            if (lane == 0) P_ADD(3, clock64() - tk);\n"),
    ("            if (kTrellis && n_try > 0) i4_trellis(mb, lane, T, E, S.b);\n",
     "            if (kTrellis && n_try > 0) i4_trellis(mb, lane, T, E, S.b);\n"
     "            if (lane == 0) P_ADD(4, clock64() - tk);\n"),
    ("            if (lane == 0) cmode[mg] = static_cast<uint8_t>(uv);\n",
     "            if (lane == 0) cmode[mg] = static_cast<uint8_t>(uv);\n"
     "            if (lane == 0) P_ADD(5, clock64() - tk);\n"),
    ("        }\n        __syncthreads();\n\n        // The decision,",
     "        }\n"
     "        const long long tc = clock64();\n"
     "        __syncthreads();\n"
     "        if (lane == 0) P_ADD(16 + warp, clock64() - tc);\n"
     "        tk = clock64();\n\n        // The decision,"),
    ("            st_release(prog + static_cast<long long>(b) * mbh + r, x + 1);\n        }\n",
     "            st_release(prog + static_cast<long long>(b) * mbh + r, x + 1);\n"
     "            P_ADD(7, clock64() - tk);\n"
     "            P_ADD(9, 1);\n"
     "            P_ADD(10, use_i4);\n"
     "            if (x == mbw - 1) P_ADD(11, clock64() - t_begin);\n"
     "        }\n"),
]


def instrument(src: str, patches, api: str) -> str:
    for anchor, repl in patches:
        n = src.count(anchor)
        if n != 1:
            raise SystemExit(f"anchor found {n} times in enc.cu: {anchor!r}")
        src = src.replace(anchor, repl)
    return src + api


def summarize_rows(probe, ms: float, steps: int) -> dict:
    """probe: uint64 [CTAs, 24] of one launch of the row-CTA K5."""
    tot = probe.sum(0).astype(float)
    slot = dict(zip(ROW_SLOTS, tot))
    mbs, i4 = slot["mbs"], slot["i4_mbs"]
    per_mb = {k: slot[k] / mbs for k in ROW_SLOTS if k not in ("mbs", "i4_mbs", "elapsed")}
    per_mb["i16_commit"] = per_mb["i16_search_commit"] - per_mb["i16_search"]
    per_mb["trellis_work"] = per_mb["trellis"] - per_mb["trellis_wait"]
    longest = float(probe[:, 11].max())
    return {"ms": ms, "mbs": int(mbs), "i4_mbs": int(i4), "steps": steps,
            "ghz_from_longest_cta": longest / (ms * 1e6),
            "longest_cta_cycles": longest, "per_mb_cycles": per_mb}


def summarize(probe, steps: int, ms: float) -> dict:
    """probe: int64 [B, 32, N_ACC] of one launch."""
    live = probe[..., 5] > 0  # warps that decided an MB
    mbs = int(probe[..., 5].sum())
    i4 = int(probe[..., 6].sum())
    elapsed = probe[..., 9].max(axis=1).astype(float)  # per image
    cycles = float(elapsed.mean())
    per_mb = {p: float(probe[..., k].sum()) / max(1, (i4 if p == "i4_commit" else
                                                       mbs - i4 if p == "i16_commit" else mbs))
              for k, p in enumerate(PHASES)}
    busy = probe[..., :5].sum(-1).astype(float)
    return {
        "ms": ms, "mbs": mbs, "i4_mbs": i4, "steps": steps,
        "cycles_per_image": cycles, "ghz": cycles / (ms * 1e6),
        "cycles_per_step": cycles / steps,
        "us_per_step": ms * 1e3 / steps,
        "per_mb_cycles": per_mb,
        "warp_busy_share": float((busy / elapsed[:, None])[live].mean()),
        "warp_barrier_share": float((probe[..., 7] / elapsed[:, None])[live].mean()),
        "phase_share_of_busy": {p: float(probe[..., k].sum() / busy.sum()) for k, p in enumerate(PHASES)},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-csrc", type=Path, help="sources of the one-block-per-image K5")
    ap.add_argument("--probe", action="store_true", help="probes in the package's (row-CTA) K5")
    ap.add_argument("--out", type=Path, help="also write the numbers to this JSON file")
    args = ap.parse_args()

    import ctypes

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import webp_tpu_torch
    from webp_tpu_torch import _build
    from webp_tpu_torch.ops import encode_wavefront as ew
    from synthetic_rgb import synthetic_frame

    dev = torch.device("cuda")
    runs = []
    inner = ew._enc_kernel
    if args.old_csrc or args.probe:
        work = ROOT / "build" / "k5_split"
        shutil.rmtree(work, ignore_errors=True)
        shutil.copytree(ROOT / "webp_tpu_torch" / "csrc", work / "csrc")
        for name in ("enc.cu", "common.cuh", "trellis.cuh") if args.old_csrc else ():
            shutil.copy(args.old_csrc / name, work / "csrc" / name)
        enc = work / "csrc" / "enc.cu"
        enc.write_text(instrument(enc.read_text(), *((PATCHES, PROBE_API) if args.old_csrc
                                                     else (ROW_PATCHES, ROW_API))))
        _build.CSRC, _build.BUILD_DIR = work / "csrc", work
        _build.LIB_PATH = work / "libk5_split.so"
        _build.PTXAS_REPORT = work / "ptxas.txt"
        lib = _build.load()
        lib.webp_k5_probe.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.webp_k5_probe.restype = ctypes.c_int
        buf = np.zeros((64, 32, N_ACC) if args.old_csrc else (8192, 24), np.int64)

        def read_probe():
            rc = lib.webp_k5_probe(buf.ctypes.data, buf.size)
            if rc != 0:
                raise RuntimeError(f"probe read failed: {rc}")
            return buf.copy()

        def timed_kernel(y, u, v, P, tbl, n_try, do_trellis, sid):
            B, H, W = y.shape
            read_probe()  # zero
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(y, u, v, P, tbl, n_try, do_trellis, sid)
            end.record()
            torch.cuda.synchronize()
            steps = (W // 16) + 2 * (H // 16 - 1)
            ms = start.elapsed_time(end)
            if args.old_csrc:
                stats = summarize(read_probe()[:B], steps, ms)
            else:
                stats = summarize_rows(read_probe()[:B * (H // 16)], ms, steps)
            runs.append({"pass": 2 if do_trellis else 1, "n_try": n_try, **stats})
            return out
    else:
        _build.load()

        def timed_kernel(y, u, v, P, tbl, n_try, do_trellis, sid):
            times = []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = inner(y, u, v, P, tbl, n_try, do_trellis, sid)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            runs.append({"pass": 2 if do_trellis else 1, "n_try": n_try,
                         "ms": sorted(times)[2], "all_ms": times,
                         "resident_rows": ew.resident_rows(do_trellis, dev),
                         "row_ctas": y.shape[0] * (y.shape[1] // 16)})
            return out

    ew._enc_kernel = timed_kernel
    frames = [synthetic_frame(768, 512, s) for s in (11, 12)]
    rgbs = [frames[i % 2] for i in range(8)]
    for _ in range(3):  # the first run includes the module load
        webp_tpu_torch.encode_frames_lossy_batch(rgbs, 75, 4, True, True, num_partitions=8,
                                                 device=dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    spills = [ln.strip() for ln in _build.PTXAS_REPORT.read_text().splitlines() if "spill" in ln]
    result = {"card": card, "ptxas_spill_lines": spills,
              "runs": runs[2:]}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(card)
    for r in result["runs"]:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())

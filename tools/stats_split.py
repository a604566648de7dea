#!/usr/bin/env python3
"""Time the flagship's statistics kernels, the decode's K1 and K4, the
encode wire's K18, K19 and K20 and the rate tables K7 on one NVIDIA GPU,
each beside an earlier commit's build of the same kernel: K8 analysis
(`webp_tpu_torch/csrc/analysis.cu`), K6 token_stats (`csrc/token_stats.cu`),
K1 residual (`csrc/residual.cu`), K4 yuv2rgb (`csrc/yuv2rgb.cu`), K18
prepack, K19 pack_levels, their fused launch and K20 wire (`csrc/wire.cu`),
K7 enc_tables (`csrc/enc_tables.cu`), the lossless K9-K11 (`csrc/vp8l.cu`)
and the flat sparse K21 and K22 (`csrc/sparse.cu`); rank the
flagship kernels by their own device time; and time the wrappers' shared
launch path.

    python3 tools/stats_split.py [--rank] [--launch]
                                 [--csrc DIR [--split K,K] [--probe] [--cold] [--segs 8,16]]
                                 [--batches 8,64] [--out FILE]

Inputs are `chip_smoke.py`'s at 768x512, tiled to each batch: the decode's
seeded random keyframes (normal loop filter) parsed on the host (K1's
sparse and dense levels, K4's planes after the fused recon + filter), and
the flagship encode's seeded synthetic frames (Q75 m4, segments on)
through K8, the host k-means and K5's pass 1 (and, for --rank, pass 2) on
the card.

--rank times K1 residual, K4 yuv2rgb, K6 token_stats, K7 enc_tables, K8
analysis and the wire's K18 prepack, K19 pack_levels, the fused K18 + K19
prepack_pack (the main path's call) and K20 wire (on the flagship's pass-2
arrays) through their wrappers in three rounds: each
call by CUDA events (the wrapper's host work included) and its kernels'
device time by the profiler, beside the kernel's bound, with flagship
launches x (device time - bound), the rule's ranking.

--launch times the wrappers' launch path on the host (`_build.launch`):
each step that the earlier path took per call (the lock of `load()`, the
`torch.cuda.device` context, the `current_stream` lookup, the `getattr` of
the entry), each step of the current one, the ctypes call alone and K9's
wrapper check, in microseconds a call over 2,000 calls; then K9
subtract_green's call through the earlier path and the current one beside
`px[..., 0:3:2].add_(px[..., 1:2])` in rounds (call by CUDA events, device
time by the profiler) on 8 x 768x512 pixels.

--csrc DIR builds DIR (an earlier commit's `webp_tpu_torch/csrc`, from
`git archive <commit> webp_tpu_torch/csrc` unpacked under `build/`) into
`build/stats_split/parent/` beside the package's sources in
`build/stats_split/package/`, and times both builds' kernels named by
--split on the same inputs in turns (parent, package, package, parent),
checking that the parent's outputs equal the package's.  K1 (sparse and
dense levels) and K4 (`--split residual,yuv2rgb`, the default) run
through the package's wrappers with either library bound, so the host
work is the same; DIR's C entry points must take the package's arguments.
K8 and K6 (`--split analysis,token_stats`) run through the C entry points
of commit 3066949's kernels with their outputs and scratch allocated as
its wrappers did.  K18 and K19 (`--split prepack,pack_levels`, DIR from
commit 819b51f, whose `webp_prepack` and `webp_pack_levels` take the
package's arguments) run through the package's wrappers with either
library bound, on the flagship's pass-2 arrays (K19 on K18's lv8 at
CAP_MB), alone and as the pair (K18 then K19), beside the package's fused
launch (`prepack_pack`, equal to the pair's outputs; DIR's too where its
library has one) in the same rounds.
K20 and K7 (`--split wire,enc_tables`, DIR from commit d2195a0) run in
turns beside the parent's: K7 through the package's wrapper with either
library bound, first on seeded probabilities (before the flagship's
inputs are made), then on the flagship's pass-1 probabilities; K20 on the
fused K18 + K19's outputs of the flagship's pass-2 arrays, the parent's
through its C entry point with a zeroed med-over buffer, as its wrapper
did; a CUDA graph of 20 calls replayed times each back to back, and each
kernel's local loads and stores in the SASS are counted.
K9, K10 and K11 (`--split vp8l`, DIR from commit 8e0eae3) run through
the package's wrappers with either library bound on the lossless phase's
streams tiled to each batch (K9 and K10 on the photo's inputs, the colour
transform at size_bits 3; K11 at 2, 4, 12 and 200 colours: 8, 4, 2 and 1
indices a byte, 12 from the palette stream, the others seeded), checked
equal on fresh copies and timed in place on one; K21 and K22 (`--split
sparse`, DIR from commit aa03fa0) on the flagship's pass-2 levels (K18's
lv8 flattened), the package's through its wrappers, the parent's through
its C entry points: K21 with its int32 tile-count scratch and vals zeroed
(the zero fill counted in its device time), K22 with its scratch zeroed;
checked equal, K22's at n = N and N - 5.  Each prints call, device time
(every kernel of the call), every device op, a CUDA graph of 20 calls,
the bound and the device time's share of it, and counts LDL / STL in
both builds' SASS.  Call by CUDA events over the call, device time by
the profiler.  `--probe` times the instrumented build: take the times
from a run without it.

--cold (with --split vp8l / sparse) also times K11 at 200 colours, K21
and K22 with their inputs cold: each call after an add_ over a 128 MB
buffer (past the 50 MB L2), which the profiler's sum leaves out; device
time only, in the same turns.

--probe adds `clock64()` probes to the package's copies of the kernels
(K11: the loads, palette and barrier included, then the gathers and
stores; K22: ticket + scan, look-back, staging, stores, finish; K21, whose
CTAs loop over tickets, each phase's cycles summed over a CTA's items:
tickets, loads + bitmap + scan (the wait for the tile's loads included),
publish + staging, look-back (to the barrier after it), stores, pad wait,
pad zeros, the reset's wait, and the tiles and pad parts a CTA took; for
K21 and K22 also each CTA's %globaltimer at its start and end: the span
of the launch, the last start, a CTA's mean life):
per CTA, thread 0's cycles from the kernel's start to the end of each
phase (K8: stage, rounds, flush; K6: stage, contexts, lists, count, flush;
K1 on the sparse form: loads, escape run, dequant + IWHT, IDCT, store; K4:
loads (the chroma taps formed), compute (to the last row's pixels,
the first row's stores sent), store; K18: loads (to the clip of the
levels), ranks (the lv8 stores, the escape ballot and, where the warp has
an escape, the scan), stores (meta8); K19: loads (to the runs' bitmap
bytes), ranks (the bitmap stores, the scan), stores (tile and copy-out);
the fused kernel K18's three phases then K19's; K20's MB CTAs: loads,
scan + staging, copy-out, and its list CTAs; K7: loads, rows, stores),
the means over CTAs printed.  A clock read does not wait for loads in flight: a phase holds
the wait for the loads whose values it uses first.

--segs 8,16,... also times the package's K8 and K6 with CTAs of that many
MBs of a row (the wrappers' default is 64).

Prints ptxas's registers and spills of each build and the card's name and
power limit.  Imports neither jax nor the JAX package.
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
WIDTH, HEIGHT = 768, 512
QUALITY, METHOD = 75, 4
RANKED = ("residual", "yuv2rgb", "token_stats", "enc_tables", "analysis", "prepack",
          "pack_levels", "prepack_pack", "wire")
# The profiler's names of each ranked kernel's __global__ functions.
WIRE_DEVICE = {"prepack": ["prepack_kernel"], "pack_levels": ["pack_levels_kernel"],
               "prepack_pack": ["prepack_pack_kernel"],
               "wire": ["wire_kernel"]}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
PARENT_SIGNATURES = {  # the one-warp-per-MB K8 and one-thread-per-block K6 (commit 3066949)
    "webp_analysis": [_P, _L, _P, _L, _P, _L, _I, _I, _I, _P, _P, _P],
    "webp_token_stats": [_P, _L, _P, _L, _P, _P, _P, _I, _I, _I, _P, _P],
}
KERNEL_NAMES = {"analysis": ["analysis_kernel"], "token_stats": ["token_stats_kernel"],
                "residual": ["residual_kernel"], "yuv2rgb": ["yuv2rgb_kernel"]}
DECODE_ENTRIES = ("webp_residual", "webp_yuv2rgb")  # K1 and K4: the package's signatures

# Probes: thread 0 of each CTA stores clock64() - its start at the end of
# each phase.  (file, anchor, inserted after the anchor); each anchor must
# occur exactly once.
N_PROBE, MAX_CTAS = 12, 65536
PROBE_DECL = f"""
static __device__ long long stats_probe[{MAX_CTAS} * {N_PROBE}];
#define PROBE_SLOT(k) stats_probe[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) \
    * {N_PROBE} + (k)]
#define PROBE_THREAD ((threadIdx.x | threadIdx.y) == 0)
#define PROBE(k) do {{ if (PROBE_THREAD) PROBE_SLOT(k) = clock64() - probe_t0; }} while (0)
#define PROBE_AT(k) do {{ if (PROBE_THREAD) PROBE_SLOT(k) = clock64(); }} while (0)
#define PROBE_SPAN(k) do {{ const long long t_ = clock64(); \
    if (PROBE_THREAD) PROBE_SLOT(k) += t_ - probe_t0; probe_t0 = t_; }} while (0)
#define PROBE_COUNT(k) do {{ if (PROBE_THREAD) PROBE_SLOT(k) += 1; }} while (0)
#define PROBE_GT(k) do {{ if (PROBE_THREAD) {{ unsigned long long t_; \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); PROBE_SLOT(k) = (long long)t_; }} }} while (0)
"""
PROBE_API = """
WEBP_API int webp_{name}_probe(void* host, int n) {{
    cudaError_t err = cudaMemcpyFromSymbol(host, stats_probe, n * sizeof(long long));
    if (err != cudaSuccess) return static_cast<int>(err);
    static long long zeros[sizeof(stats_probe) / sizeof(long long)];
    return static_cast<int>(cudaMemcpyToSymbol(stats_probe, zeros, sizeof(zeros)));
}}
"""
PHASES = {"analysis": ("stage", "rounds", "flush"),
          "token_stats": ("stage", "contexts", "lists", "count", "flush"),
          "residual": ("loads", "escape run", "dequant + IWHT", "IDCT", "store"),
          "yuv2rgb": ("loads", "compute", "store")}
# The wire kernels' probes store the clock itself (PROBE_AT: the shared
# device functions have no start of their own): kernel -> (phase, slot),
# each phase ending at its slot and starting at the one before.
WIRE_PHASES = {
    "prepack": (("start", 0), ("loads", 1), ("ranks", 2), ("stores", 3)),
    "pack_levels": (("start", 0), ("loads", 4), ("ranks", 5), ("stores", 6)),
    "prepack_pack": (("start", 0), ("K18 loads", 1), ("K18 ranks", 2), ("K18 stores", 3),
                     ("K19 bitmap", 4), ("K19 ranks", 5), ("K19 stores", 6)),
}
PATCHES = {
    "analysis.cu": [
        ('#include "common.cuh"\n', PROBE_DECL),
        ("    const Geometry G = geometry(min(seg_mbs, mbw - x0));\n",
         "    const long long probe_t0 = clock64();\n"),
        ("    if (tid == 0) *cta_sum = 0;\n    __syncthreads();\n", "    PROBE(0);\n"),
        ("    if (lane == 0) atomicAdd(cta_sum, uv_part);\n    __syncthreads();\n",
         "    PROBE(1);\n"),
        ("            img[1] = 0;\n        }\n", "        PROBE(2);\n"),
    ],
    "token_stats.cu": [
        ('#include "common.cuh"\n', PROBE_DECL),
        ("    const Layout L = layout(seg);\n", "    const long long probe_t0 = clock64();\n"),
        ("    cp_async_wait<0>();\n    __syncthreads();\n", "    PROBE(0);\n"),
        ("            carry = last >= 0 ? last & 1 : carry;\n        }\n    }\n"
         "    __syncthreads();\n", "    PROBE(1);\n"),
        ("            if (cls == c) lists[c * seg * 25 + at] = word;\n        }\n    }\n"
         "    __syncthreads();\n", "    PROBE(2);\n"),
        ("* 3 + ctx) * kCodes + code], 1);\n        }\n    }\n    __syncthreads();\n",
         "    PROBE(3);\n"),
        ("        if (tid == 0) img_acc[2 * kCounters] = 0;\n    }\n", "    PROBE(4);\n"),
    ],
    "residual.cu": [
        ('#include "common.cuh"\n', PROBE_DECL),
        ("    const bool owner = lane < kBlocks;\n", "    const long long probe_t0 = clock64();\n"),
        ("            lv[i] = val;\n        }\n", "        PROBE(0);\n"),
        ("            if (!more) break;\n        }\n", "        PROBE(1);\n"),
        ("        if (lane < 16) lv[0] = mine;\n    }\n", "    PROBE(2);\n"),
        ("    idct4x4(lv);\n", "    PROBE(3);\n"),
        ("    if (lane == 0) do_sub[mb] = sub ? 1 : 0;\n", "    PROBE(4);\n"),
    ],
    "yuv2rgb.cu": [
        ('#include "common.cuh"\n', PROBE_DECL),
        ("    const bool two = 2 * k + 1 < height;\n", "    const long long probe_t0 = clock64();\n"),
        ("two ? luma8<kVec>(yrow + ystride) : 0};\n", "    PROBE(0);\n"),
        ("(width * 3) + j0 * 3;\n", "        PROBE(1);\n"),
        ("        store_row(out, w, n);\n    }\n", "    PROBE(2);\n"),
    ],
    "wire.cu": [
        ('#include "common.cuh"\n', PROBE_DECL),
        ("uint8_t* __restrict__ over, uint2& run_a, uint2& run_b) {\n", "    PROBE_AT(0);\n"),
        ("    run_b = clip_run(raw_b, esc_b);\n", "    PROBE_AT(1);\n"),
        ("        if (lane == 0 && n > kEsc) over[b] = 1;\n    }\n", "    PROBE_AT(2);\n"),
        ("        out[lane] = static_cast<uint8_t>(meta);\n    }\n", "    PROBE_AT(3);\n"),
        ("    const int8_t* row = lv8 + mb * kSlots;  // 8-byte aligned (the wrapper checks lv8)\n",
         "    PROBE_AT(0);\n"),
        ("bits_b = nonzero_bits(run_b);\n", "    PROBE_AT(4);\n"),
        ("n = n_a + (total >> 16);\n    const int chunks = (cap + 15) / 16;\n",
         "    PROBE_AT(5);\n"),
        ("    if (lane == 0 && n > cap) over[b] = 1;\n", "    PROBE_AT(6);\n"),
    ],
}
# K20 and K7 (PROBE, relative to the CTA's start): K20's MB CTAs end at
# slot 2, its list CTAs (x = 0) store slot 3 alone.
PHASES["wire"] = ("loads", "scan + staging", "copy-out", "list CTA")
PHASES["enc_tables"] = ("loads", "rows", "stores")
PATCHES["wire.cu"] += [
    ("    uint8_t* w = wire + b * row;\n", "    const long long probe_t0 = clock64();\n"),
    ("hot[h] = med_bits(run[h]);  // 0 past the image's MBs\n", "    PROBE(0);\n"),
    ("cta_med = 1;\n    __syncthreads();\n", "    PROBE(1);\n"),
    ("            *word = 0;\n        }\n    }\n", "    PROBE(2);\n"),
    ("        wire_list(esc_pos, esc_val, overflow, nmb, b, w, sh.list, sums);\n", "        PROBE(3);\n"),
]
PATCHES["enc_tables.cu"] = [
    ('#include "common.cuh"\n', PROBE_DECL),
    ("    const long long img_type = static_cast<long long>(blockIdx.y) * 4 + blockIdx.x;\n",
     "    const long long probe_t0 = clock64();\n"),
    ("[tid - 64 - kCodes];\n    }\n    __syncthreads();\n", "    PROBE(0);\n"),
    ("cost[lane * kLevels + v] = c;\n        }\n    }\n    __syncthreads();\n", "    PROBE(1);\n"),
    ("            make_int4(v[0], v[1], v[2], v[3]);\n    }\n", "    PROBE(2);\n"),
]
# K11 and K22 (PROBE, relative to the CTA's start).
PHASES["color_indexing"] = ("loads", "gather + stores")
PHASES["expand_flat"] = ("ticket + scan", "look-back", "staging", "stores", "finish")
PATCHES["vp8l.cu"] = [
    ('#include "common.cuh"\n', PROBE_DECL),
    ("    const int b = blockIdx.y, tid = threadIdx.x, r0 = blockIdx.x * rows;\n",
     "    const long long probe_t0 = clock64();\n"),
    ("            palette[tid] = pal;\n            __syncthreads();\n", "            PROBE(0);\n"),
    ("if (x + j >= 0 && x + j < width) o[j] = v[j];\n                }\n            }\n        }\n"
     "    }\n", "    PROBE(1);\n"),
]
PATCHES["sparse.cu"] = [
    ('#include "common.cuh"\n', PROBE_DECL),
    # K22
    ("int8_t* __restrict__ out) {\n", "    const long long probe_t0 = clock64();\n    PROBE_GT(10);\n"),
    ("&total);\n\n    // 2. The tile's offset in the image.\n", "    PROBE(0);\n"),
    ("    // 3. The values of ranks off .. off + total - 1 (each at most cap - 1),\n",
     "    PROBE(1);\n"),
    ("    // 4. The thread's bytes: slot k takes the value of its rank if set.\n",
     "    PROBE(2);\n"),
    ("        store_span<false>(dst, sh.tile_bytes, len, tid);\n    }\n", "    PROBE(3);\n"),
    ("    PROBE(3);\n    if (warp == 0) finish(head, status, ntiles, lane);\n",
     "    PROBE(4);\n    PROBE_GT(11);\n"),
    # K21: each phase's cycles summed over the CTA's items (PROBE_SPAN)
    ("uint8_t* __restrict__ over) {\n", "    long long probe_t0 = clock64();\n    PROBE_GT(10);\n"),
    ("    if (item < ntiles) load_slots(row, N, item, tid, w);\n", "    PROBE_SPAN(0);\n"),
    ("            const int count = sh.count, part = item - ntiles;\n", "            PROBE_SPAN(5);\n"),
    ("cap - count, tid, part, pads);\n", "            PROBE_SPAN(6);\n            PROBE_COUNT(9);\n"),
    ("            item = take_ticket(head, &sh.tile);  // past the tiles: a part of the pad or none\n",
     "            PROBE_SPAN(0);\n"),
    ("&total);\n\n        // 2. The tile's count published; the nonzeros staged at their rank\n",
     "        PROBE_SPAN(1);\n"),
    ("        const int next = sh.tile;\n", "        PROBE_SPAN(2);\n"),
    ("        const int off = sh.off;\n", "        PROBE_SPAN(3);\n"),
    ("max(0, min(total, cap - off)),\n                          tid);\n",
     "        PROBE_SPAN(4);\n        PROBE_COUNT(8);\n"),
    ("        reset_when_done(head, status, gridDim.x - 1, ntiles, lane);\n",
     "        PROBE_SPAN(7);\n"),
    ("        reset_when_done(head, status, gridDim.x - 1, ntiles, lane);\n        PROBE_SPAN(7);\n    }\n",
     "    PROBE_GT(11);\n"),
]
# The CTAs' %globaltimer at their start and end (after the last phase).
TIMELINE = {"pack_flat": (10, 11), "expand_flat": (10, 11)}
PHASES["pack_flat"] = ("tickets", "loads + bitmap + scan", "publish + staging", "look-back",
                       "stores", "pad wait", "pad zeros", "reset wait", "tiles", "pad parts")
SPANS = {"pack_flat"}  # each slot holds its phase's sum over the CTA's items
PTXAS_NAMES = {"color_indexing_kernelILi0E": "color_indexing<unpacked>",
               "color_indexing_kernel_2": "color_indexing<2 a byte>",
               "color_indexing_kernelILi2E": "color_indexing<4 a byte>",
               "color_indexing_kernelILi3E": "color_indexing<8 a byte>",
               "color_indexing_kernel": "color_indexing", "expand_flat_kernel": "expand_flat",
               "pack_flat_kernel": "pack_flat", "tile_count_kernel": "tile_count",
               "tile_scan_kernel": "tile_scan",
               "analysis_kernel": "analysis", "token_stats_kernel": "token_stats",
               "residual_kernel": "residual", "yuv2rgb_kernelILb1E": "yuv2rgb (vector loads)",
               "yuv2rgb_kernelILb0E": "yuv2rgb (byte loads)", "yuv2rgb_kernel": "yuv2rgb",
               "prepack_pack_kernel": "prepack_pack", "prepack_kernel": "prepack",
               "pack_levels_kernel": "pack_levels", "wire_kernel": "wire",
               "wire_mb_kernel": "wire_mb", "wire_list_kernel": "wire_list",
               "enc_tables_kernel": "enc_tables"}


def instrument(csrc: Path) -> None:
    for name, patches in PATCHES.items():
        path = csrc / name
        src = path.read_text()
        for anchor, insert in patches:
            n = src.count(anchor)
            if n != 1:
                raise SystemExit(f"{name}: probe anchor found {n} times, not once: "
                                 f"{anchor[:60]!r}")
            src = src.replace(anchor, anchor + insert)
        path.write_text(src + PROBE_API.format(name=name[:-3]))


def ptxas_lines(report: Path) -> list:
    out, name = [], None
    for line in report.read_text().splitlines():
        if "Compiling entry function" in line:
            name = next((v for k, v in PTXAS_NAMES.items() if k in line), None)
        elif name and ("spill" in line or "registers" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def build(_build, csrc: Path, work: Path, probe: bool = False, bind: bool = True):
    """Copy `csrc` into `work` (patched for the probes), build it there and
    load it: through `_build.load`, which binds the package's entry points,
    or with ctypes alone."""
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(csrc, work / "csrc")
    if probe:
        instrument(work / "csrc")
    _build.CSRC, _build.BUILD_DIR = work / "csrc", work
    _build.LIB_PATH = work / "libstats_split.so"
    _build.PTXAS_REPORT = work / "ptxas.txt"
    _build._lib = None
    if bind:
        return _build.load()
    _build._build()
    return ctypes.CDLL(str(_build.LIB_PATH))


def decode_inputs(dev, batch: int) -> dict:
    """K1's sparse arguments ("k1"), its dense ones ("k1_dense"), its
    outputs ("res"), K4's planes after the fused recon + filter ("planes")
    and the crop ("size")."""
    import torch

    import chip_smoke
    from webp_tpu_torch.decode import device as tdev
    from webp_tpu_torch.ops import residual
    from webp_tpu_torch.ops.recon_filter import recon_filter_

    payloads = [p for p, _, _ in chip_smoke.make_payloads(WIDTH, HEIGHT, simple=False)]
    host = tdev.parse_levels_batch([payloads[i % len(payloads)] for i in range(batch)])
    d = tdev.to_device_batch(host, dev)
    mbw, mbh, simple, width, height = tdev.geometry(host["headers"])
    nmb = mbw * mbh
    f = tdev.field_views(d["u8buf"], nmb)
    mb = (f["segment_ids"], f["luma_mode"], f["skipped"], f["non_zero"])
    k1_args = [d[k] for k in ("bitmap", "vals", "esc_pos", "esc_val", "qtab")] + list(mb)
    res, do_sub = residual.residuals_sparse(*k1_args)
    planes = tdev.split_planes(torch.zeros((batch, nmb * 384), dtype=torch.uint8, device=dev),
                               mbw, mbh)
    recon_filter_(*planes, res, f["luma_mode"], f["bpred"], f["chroma_mode"], f["level"],
                  f["interior"], f["hev"], do_sub, simple)
    return {"k1": k1_args, "k1_dense": [torch.from_numpy(host["i16buf"]).to(dev), *mb],
            "res": (res, do_sub), "planes": planes, "size": (width, height)}


def encode_inputs(dev, batch: int, pass2: bool = False):
    """The flagship's planes, K8's outputs, pass 1's token_stats arguments
    (with the skip flags), its statistics' adapted probabilities and, where
    `pass2`, pass 2's arrays on the tables of those probabilities."""
    import torch

    import chip_smoke
    from webp_tpu_torch.common import vp8_tables as T
    from webp_tpu_torch.encode import device as edev
    from webp_tpu_torch.ops.analysis import analyze_alphas_batch
    from webp_tpu_torch.ops.enc_params import EncTables
    from webp_tpu_torch.ops.encode_wavefront import encode_analysis_batch
    from webp_tpu_torch.ops.token_stats import token_stats

    distinct, _ = chip_smoke.encode_inputs(WIDTH, HEIGHT)
    rgbs = [distinct[i % len(distinct)] for i in range(batch)]
    y, u, v = edev.upload(edev.rgb_to_planes(rgbs), dev)
    alphas = analyze_alphas_batch(y, u, v)
    segs = edev.segment(y, u, v, QUALITY)
    P, sid = edev.params_for(segs, QUALITY, dev)
    default = EncTables.from_probs(T.COEFF_PROBS_DEFAULT, dev)
    n_try = edev.n_try_for(METHOD)
    pass1 = encode_analysis_batch(y, u, v, P, default, min(n_try, 3), False, sid)
    mbw, mbh = WIDTH // 16, HEIGHT // 16
    stat_args = (pass1["luma_mode"], pass1["y2_levels"], pass1["y_levels"], pass1["uv_levels"],
                 edev.skip_flags(pass1), mbw, mbh)
    stats = token_stats(*stat_args)
    probs_h = edev.adapt_probs(stats[0].cpu().numpy(), stats[1].cpu().numpy())
    p2 = (encode_analysis_batch(y, u, v, P, edev.tables_for(probs_h, dev), n_try, METHOD >= 4, sid)
          if pass2 else None)
    return (y, u, v), alphas, stat_args, stats, torch.from_numpy(probs_h).to(dev), p2


def ranked_calls(dev, batch: int) -> dict:
    """name -> (call, kernel names, bound record) of the ranked kernels."""
    import chip_smoke as cs
    from webp_tpu_torch.ops import residual, wire
    from webp_tpu_torch.ops.analysis import analyze_alphas_batch
    from webp_tpu_torch.ops.enc_params import EncTables
    from webp_tpu_torch.ops.enc_tables import enc_tables
    from webp_tpu_torch.ops.sparse import pack_levels_mb
    from webp_tpu_torch.ops.token_stats import token_stats
    from webp_tpu_torch.ops.yuv import fancy_yuv420_to_rgb

    dec = decode_inputs(dev, batch)
    k1_args, k1_out, planes, (width, height) = dec["k1"], dec["res"], dec["planes"], dec["size"]
    rgb = fancy_yuv420_to_rgb(*planes, width, height)
    (y, u, v), alphas, stat_args, stats, probs, pass2 = encode_inputs(dev, batch, pass2=True)
    tables = enc_tables(probs)
    pre = wire.prepack(pass2)
    packed = pack_levels_mb(pre[0], wire.CAP_MB)
    rows = wire.wire(*packed, *pre[1:])
    nmb = (WIDTH // 16) * (HEIGHT // 16)
    n_mb = batch * nmb
    return {  # the bounds as chip_smoke.py counts them
        "residual": (lambda: residual.residuals_sparse(*k1_args),
                     cs.bound(cs.nbytes(*k1_args, *k1_out), batch * nmb * 25 * (16 + 96))),
        "yuv2rgb": (lambda: fancy_yuv420_to_rgb(*planes, width, height),
                    cs.bound(cs.nbytes(*planes, rgb), batch * width * height * 25)),
        "token_stats": (lambda: token_stats(*stat_args),
                        cs.bound(cs.nbytes(*stat_args[:5], *stats), batch * nmb * 25 * 16 * 12)),
        "enc_tables": (lambda: enc_tables(probs),
                       cs.bound(cs.nbytes(probs, *(getattr(tables, f) for f in EncTables.FIELDS)),
                                batch * 4 * 16 * 3 * (68 + 11 + 2) * 33)),
        "analysis": (lambda: analyze_alphas_batch(y, u, v),
                     cs.bound(cs.nbytes(y, u, v, *alphas), batch * nmb * 48 * 160)),
        "prepack": (lambda: wire.prepack(pass2),
                    cs.bound(cs.nbytes(*pass2.values(), *pre),
                             n_mb * wire.SLOTS * cs.OPS_PREPACK_SLOT)),
        "pack_levels": (lambda: pack_levels_mb(pre[0], wire.CAP_MB),
                        cs.bound(cs.nbytes(pre[0], *packed), n_mb * wire.SLOTS * cs.OPS_PACK_SLOT)),
        "prepack_pack": (lambda: wire.prepack_pack(pass2),
                         cs.bound(cs.nbytes(*pass2.values(), *pre, *packed),
                                  n_mb * wire.SLOTS * (cs.OPS_PREPACK_SLOT + cs.OPS_PACK_SLOT))),
        "wire": (lambda: wire.wire(*packed, *pre[1:]),
                 cs.bound(cs.nbytes(*packed, *pre[1:], rows),
                          n_mb * (wire.CAP_MB * cs.OPS_WIRE_VALUE
                                  + wire.N_ESC * cs.OPS_LIST_SLOT))),
    }


def rank(dev, card: str, batches, rounds: int = 3) -> dict:
    import chip_smoke as cs

    out = {}
    for batch in batches:
        calls = ranked_calls(dev, batch)
        times = {k: {"call": [], "device": []} for k in calls}
        for _ in range(rounds):
            for k, (fn, _) in calls.items():
                times[k]["call"].append(cs.time_ms(fn, 20))
                times[k]["device"].append(cs.device_total(
                    cs.device_ms(fn, 20, {**cs.FLAGSHIP_DEVICE, **WIRE_DEVICE}[k])))
        rec = {}
        for k, (fn, b) in calls.items():
            dev_ms = statistics.median(times[k]["device"])
            rec[k] = {"call_ms": times[k]["call"], "device_ms": times[k]["device"], **b,
                      "gap_ms": dev_ms - b["bound_ms"]}
        order = sorted(rec, key=lambda k: -rec[k]["gap_ms"])
        for k in order:
            r = rec[k]
            print(f"rank batch {batch}: {k}: call {' / '.join(f'{t:.4f}' for t in r['call_ms'])} "
                  f"ms, device {' / '.join(f'{t:.4f}' for t in r['device_ms'])} ms, bound "
                  f"{r['bound_ms']:.4f} ms by {r['bound_by']}, 1 x (device - bound) "
                  f"{r['gap_ms']:.4f} ms ({card})", flush=True)
        out[batch] = {"order": order, "kernels": rec}
    return out


def split_stats(dev, card: str, batches, lib, parent, probe: bool, segs=()) -> dict:
    """K8 and K6 of the package beside commit 3066949's, in turns, per batch."""
    import torch

    import chip_smoke as cs
    from webp_tpu_torch import _build
    from webp_tpu_torch.ops import analysis, token_stats as k6

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def parent_analysis(y, u, v):  # the parent wrapper's allocations and finish
        B, H, W = y.shape
        mbh, mbw = H // 16, W // 16
        alpha = torch.empty((B, mbh * mbw), dtype=torch.int32, device=dev)
        uv_sum = torch.zeros(B, dtype=torch.int64, device=dev)
        rc = parent.webp_analysis(*_build.plane(y, B, H, W), *_build.plane(u, B, H // 2, W // 2),
                                  *_build.plane(v, B, H // 2, W // 2), mbw, mbh, B,
                                  alpha.data_ptr(), uv_sum.data_ptr(), stream())
        if rc:
            raise RuntimeError(f"parent webp_analysis: CUDA error {rc}")
        return alpha, (uv_sum // (mbh * mbw)).to(torch.int32)

    def parent_stats(lm, y2, y, uv, skipped, mbw, mbh):
        B, nmb = lm.shape
        out = torch.zeros((2, B, 4, 8, 3, 11), dtype=torch.int32, device=dev)
        rc = parent.webp_token_stats(*_build.mb_field(lm, B, nmb),
                                     *_build.mb_field(skipped, B, nmb), y2.data_ptr(),
                                     y.data_ptr(), uv.data_ptr(), mbw, mbh, B, out.data_ptr(),
                                     stream())
        if rc:
            raise RuntimeError(f"parent webp_token_stats: CUDA error {rc}")
        return out[0], out[1]

    for name, argtypes in PARENT_SIGNATURES.items():
        getattr(parent, name).argtypes = argtypes
        getattr(parent, name).restype = ctypes.c_int
    out = {}
    for batch in batches:
        planes, _, stat_args, _, _, _ = encode_inputs(dev, batch)
        lv, (mbw, mbh) = stat_args[:4], stat_args[5:]
        skipped = stat_args[4]
        calls = {
            "analysis": {"package": lambda: analysis._analysis_kernel(*planes, analysis.SEG_MBS),
                         "parent": lambda: parent_analysis(*planes)},
            "token_stats": {"package": lambda: k6._token_stats_kernel(*lv, skipped, mbw, mbh),
                            "parent": lambda: parent_stats(*lv, skipped, mbw, mbh)},
            # pass 1's K6 step: the parent's skip flags then K6, the package's K6 alone
            "token_stats_path": {"package": lambda: k6.token_stats_levels(*lv, mbw, mbh),
                                 "parent": lambda: parent_stats(*lv, k6.skip_flags(*lv[1:]),
                                                                mbw, mbh)},
        }
        rec = {}
        for k, fns in calls.items():
            got = {who: fn() for who, fn in fns.items()}
            torch.cuda.synchronize()
            for a, b in zip(got["package"], got["parent"]):
                if not torch.equal(a, b):
                    raise AssertionError(f"{k} at batch {batch}: the package differs from the "
                                         "parent")
            # Device time of the kernel, and of every device op of the call
            # (the parent's memsets and finishing kernels, the skip flags).
            r = {"call_ms": {}, "device_ms": {}, "device_all_ms": {}}
            names = KERNEL_NAMES["token_stats" if k == "token_stats_path" else k]
            for who in ("parent", "package", "package", "parent"):
                r["call_ms"].setdefault(who, []).append(cs.time_ms(fns[who], 20))
                r["device_ms"].setdefault(who, []).append(
                    cs.device_total(cs.device_ms(fns[who], 20, names)))
                r["device_all_ms"].setdefault(who, []).append(
                    cs.device_total(cs.device_ms(fns[who], 20, [""])))
            rec[k] = r
            text = "; ".join(f"{who} " + ", ".join(
                f"{what} {' / '.join('n/a' if t is None else f'{t:.4f}' for t in r[key][who])}"
                for what, key in (("call", "call_ms"), ("device", "device_ms"),
                                  ("device all", "device_all_ms"))) + " ms"
                for who in ("package", "parent"))
            print(f"batch {batch}: {k}: {text}; outputs equal ({card})", flush=True)
        for seg in segs:
            for k, fn in (("analysis", lambda: analysis._analysis_kernel(*planes, seg)),
                          ("token_stats", lambda: k6._token_stats_kernel(*lv, skipped, mbw, mbh,
                                                                         seg))):
                t = [cs.device_total(cs.device_ms(fn, 20, KERNEL_NAMES[k])) for _ in range(2)]
                rec.setdefault(f"{k}_segs", {})[seg] = t
                print(f"batch {batch}: {k} with CTAs of {seg} MBs: device "
                      f"{' / '.join('n/a' if x is None else f'{x:.4f}' for x in t)} ms ({card})",
                      flush=True)
        if probe:
            for k, seg in (("analysis", analysis.SEG_MBS), ("token_stats", k6.SEG_MBS)):
                rec[k]["cycles_per_cta"] = probe_cycles(lib, k, batch * mbh * -(-mbw // seg),
                                                        calls[k]["package"], batch, card)
        out[batch] = rec
    return out


def probe_cycles(lib, k: str, ctas: int, fn, batch: int, card: str, reached=False,
                 source: str = "") -> dict:
    """Mean cycles a CTA by phase of kernel k over one call of fn(); with
    `reached`, each phase's mean is over the CTAs that reached its end (a
    nonzero slot), for kernels whose CTAs take different paths.  `source`:
    the stem of the kernel's file where it is not k."""
    import torch

    reader = getattr(lib, f"webp_{source or k}_probe")
    reader.argtypes, reader.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    n = N_PROBE * ctas
    buf = (ctypes.c_longlong * n)()
    reader(buf, n)  # read and zero
    fn()
    torch.cuda.synchronize()
    if reader(buf, n) != 0:
        raise RuntimeError("the probe read failed")
    cyc = {}
    if k in SPANS:  # the means over the CTAs that ran of each slot
        ran = [c for c in range(ctas) if buf[c * N_PROBE + TIMELINE[k][0]]]
        for i, ph in enumerate(PHASES[k]):
            cyc[ph] = statistics.mean(buf[c * N_PROBE + i] for c in ran)
        cyc["CTAs"] = len(ran)
    for i, ph in enumerate(() if k in SPANS else PHASES[k]):
        at = [c for c in range(ctas) if buf[c * N_PROBE + i]] if reached else range(ctas)
        cyc[ph] = statistics.mean(buf[c * N_PROBE + i] - (buf[c * N_PROBE + i - 1] if i else 0)
                                  for c in at) if at else 0.0
    cyc["total"] = sum(v for p, v in cyc.items() if p not in ("tiles", "pad parts", "CTAs"))
    print(f"batch {batch}: {k} probe, mean cycles a CTA by phase "
          f"{({p: round(c, 2) for p, c in cyc.items()})} ({card})", flush=True)
    if k in TIMELINE:
        first, last = TIMELINE[k]
        ran = [c for c in range(ctas) if buf[c * N_PROBE + first]]
        start = [buf[c * N_PROBE + first] for c in ran]
        end = [buf[c * N_PROBE + last] for c in ran]
        t0 = min(start)
        cyc["timeline_us"] = line = {
            "span": (max(end) - t0) / 1e3, "last start": (max(start) - t0) / 1e3,
            "mean CTA": statistics.mean(e - s for s, e in zip(start, end)) / 1e3,
            "median end": (statistics.median(end) - t0) / 1e3}
        print(f"batch {batch}: {k} timeline (%globaltimer, us from the first CTA's start) "
              f"{({p: round(v, 2) for p, v in line.items()})} ({card})", flush=True)
    return cyc


def bind(_build, lib, entries: dict) -> None:
    """Point the wrappers' launches at `lib` (its bound entry points `entries`)."""
    _build._lib, _build._entries = lib, entries


def split_decode(dev, card: str, batches, lib, parent, probe: bool) -> dict:
    """K1 (sparse and dense levels) and K4 of the package beside the
    parent's, through the package's wrappers with either library bound, in
    turns, per batch."""
    import torch

    import chip_smoke as cs
    from webp_tpu_torch import _build
    from webp_tpu_torch.ops import residual
    from webp_tpu_torch.ops.yuv import RUN, fancy_yuv420_to_rgb

    for name in DECODE_ENTRIES:
        getattr(parent, name).argtypes = _build._SIGNATURES[name]
        getattr(parent, name).restype = ctypes.c_int
    parent.webp_error_string.argtypes = [ctypes.c_int]
    parent.webp_error_string.restype = ctypes.c_char_p
    libs = {"package": (lib, dict(_build._entries)),
            "parent": (parent, {n: getattr(parent, n) for n in DECODE_ENTRIES})}
    out = {}
    for batch in batches:
        dec = decode_inputs(dev, batch)
        width, height = dec["size"]
        calls = {"residual": lambda: residual.residuals_sparse(*dec["k1"]),
                 "residual_dense": lambda: residual.residuals_dense(*dec["k1_dense"]),
                 "yuv2rgb": lambda: fancy_yuv420_to_rgb(*dec["planes"], width, height)}
        rec = {}
        for k, fn in calls.items():
            got = {}
            for who in ("package", "parent"):
                bind(_build, *libs[who])
                got[who] = fn()
            torch.cuda.synchronize()
            pairs = zip(got["package"], got["parent"]) if isinstance(got["package"], tuple) else [
                (got["package"], got["parent"])]
            for a, b in pairs:
                if not torch.equal(a, b):
                    raise AssertionError(f"{k} at batch {batch}: the package differs from the "
                                         "parent")
            names = KERNEL_NAMES["residual" if k.startswith("residual") else k]
            r = {"call_ms": {}, "device_ms": {}}
            for who in ("parent", "package", "package", "parent"):
                bind(_build, *libs[who])
                r["call_ms"].setdefault(who, []).append(cs.time_ms(fn, 20))
                r["device_ms"].setdefault(who, []).append(
                    cs.device_total(cs.device_ms(fn, 20, names)))
            bind(_build, *libs["package"])
            rec[k] = r
            text = "; ".join(f"{who} " + ", ".join(
                f"{what} {' / '.join('n/a' if t is None else f'{t:.4f}' for t in r[key][who])}"
                for what, key in (("call", "call_ms"), ("device", "device_ms"))) + " ms"
                for who in ("package", "parent"))
            print(f"batch {batch}: {k}: {text}; outputs equal ({card})", flush=True)
        if probe:
            nmb = dec["k1"][5].shape[1]
            rec["residual"]["cycles_per_cta"] = probe_cycles(
                lib, "residual", batch * -(-nmb // residual.WARPS), calls["residual"], batch, card)
            runs, pairs = -(-width // RUN), (height + 1) // 2
            ctas = batch * -(-runs // 32) * -(-pairs // 4)
            rec["yuv2rgb"]["cycles_per_cta"] = probe_cycles(lib, "yuv2rgb", ctas,
                                                            calls["yuv2rgb"], batch, card)
        out[batch] = rec
    return out


WIRE_ENTRIES = ("webp_prepack", "webp_pack_levels")  # K18 and K19: the package's signatures


def split_wire(dev, card: str, batches, lib, parent, probe: bool) -> dict:
    """K18 and K19 of the package beside the parent's, through the
    package's wrappers with either library bound, alone and as the pair,
    and the package's fused launch beside both pairs, in turns, per batch,
    on the flagship's pass-2 arrays."""
    import torch

    import chip_smoke as cs
    from webp_tpu_torch import _build
    from webp_tpu_torch.ops import wire
    from webp_tpu_torch.ops.sparse import pack_levels_mb

    entries = [n for n in (*WIRE_ENTRIES, "webp_prepack_pack") if hasattr(parent, n)]
    for name in entries:
        getattr(parent, name).argtypes = _build._SIGNATURES[name]
        getattr(parent, name).restype = ctypes.c_int
    parent.webp_error_string.argtypes = [ctypes.c_int]
    parent.webp_error_string.restype = ctypes.c_char_p
    libs = {"package": (lib, dict(_build._entries)),
            "parent": (parent, {n: getattr(parent, n) for n in entries})}
    fused_of = ["package"] + (["parent"] if "webp_prepack_pack" in entries else [])
    names = {"prepack": WIRE_DEVICE["prepack"], "pack_levels": WIRE_DEVICE["pack_levels"],
             "pair": WIRE_DEVICE["prepack"] + WIRE_DEVICE["pack_levels"],
             "prepack_pack": WIRE_DEVICE["prepack_pack"]}
    out = {}
    for batch in batches:
        *_, pass2 = encode_inputs(dev, batch, pass2=True)
        lv8 = wire.prepack(pass2)[0]

        def pair():
            pre = wire.prepack(pass2)
            return (*pre, *pack_levels_mb(pre[0], wire.CAP_MB))

        calls = {"prepack": lambda: wire.prepack(pass2),
                 "pack_levels": lambda: pack_levels_mb(lv8, wire.CAP_MB), "pair": pair}
        rec = {}
        for k, fn in calls.items():
            got = {}
            for who in ("package", "parent"):
                bind(_build, *libs[who])
                got[who] = fn()
            fused = []
            for who in fused_of if k == "pair" else ():
                bind(_build, *libs[who])
                fused.append(wire.prepack_pack(pass2))
            bind(_build, *libs["package"])
            torch.cuda.synchronize()
            for a, b in zip(got["package"], got["parent"]):
                if not torch.equal(a, b):
                    raise AssertionError(f"{k} at batch {batch}: the package differs from the "
                                         "parent")
            if not all(all(map(torch.equal, f, got["package"])) for f in fused):
                raise AssertionError(f"prepack_pack at batch {batch} differs from the pair")
            order = ("parent", "package", "package", "parent")
            if k == "pair":  # the fused launch in the same rounds (a parent's too, if it has one)
                fused_who = [f"{who} fused" for who in fused_of]
                order = ("parent", "package", *fused_who, *fused_who[::-1], "package", "parent")
            r = {"call_ms": {}, "device_ms": {}}
            for who in order:
                lib_of = who.split()[0]
                bind(_build, *libs[lib_of])
                f = (lambda: wire.prepack_pack(pass2)) if who.endswith("fused") else fn
                n = names["prepack_pack" if who.endswith("fused") else k]
                r["call_ms"].setdefault(who, []).append(cs.time_ms(f, 20))
                r["device_ms"].setdefault(who, []).append(
                    cs.device_total(cs.device_ms(f, 20, n)))
            bind(_build, *libs["package"])
            rec[k] = r
            text = "; ".join(f"{who} " + ", ".join(
                f"{what} {' / '.join('n/a' if t is None else f'{t:.4f}' for t in r[key][who])}"
                for what, key in (("call", "call_ms"), ("device", "device_ms"))) + " ms"
                for who in r["call_ms"])
            print(f"batch {batch}: {k}: {text}; outputs equal ({card})", flush=True)
        if probe:
            ctas = batch * -(-lv8.shape[1] // 8)
            for k, fn in (("prepack", calls["prepack"]), ("pack_levels", calls["pack_levels"]),
                          ("prepack_pack", lambda: wire.prepack_pack(pass2))):
                rec.setdefault(k, {})["cycles_per_cta"] = wire_probe_cycles(lib, k, ctas, fn,
                                                                            batch, card)
        out[batch] = rec
    return out


TABLES_WIRE_DEVICE = {"wire": ["wire"], "enc_tables": ["enc_tables_kernel"]}  # either build's
SEEDED_PROBS = 3  # seed of K7's probabilities before the flagship's inputs


def graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """ms a call of fn() back to back on the device: `calls` calls captured
    in one CUDA graph, replayed `replays` times between CUDA events (no
    host work between the kernels)."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (calls * replays)


def flagship_jobs(dev, batches, first):
    """The jobs `first`, then per kernel and batch (kernel, batch, pass 1's
    probabilities, the fused K18 + K19's outputs) of the flagship, its
    inputs made only after `first` has run."""
    from webp_tpu_torch.ops import wire

    yield from first
    inputs = {}
    for batch in batches:
        *_, probs, pass2 = encode_inputs(dev, batch, pass2=True)
        inputs[batch] = probs, wire.prepack_pack(pass2)
    for k in ("enc_tables", "wire"):
        for batch in batches:
            probs, packed = inputs[batch]
            yield (k, batch, probs, None) if k == "enc_tables" else (k, batch, None, packed)


def split_tables_wire(dev, card: str, batches, lib, parent, probe: bool) -> dict:
    """K20 and K7 of the package beside commit d2195a0's (K20 as two
    kernels and a zeroed med-over buffer; K7 a thread per entry), in turns,
    per batch, on the flagship's pass-2 arrays (K20 on the fused K18 + K19's
    outputs) and pass 1's adapted probabilities.  K7 runs through the
    package's wrapper with either library bound; the parent's K20 through
    its C entry point with its outputs and scratch allocated as its wrapper
    did."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from webp_tpu_torch import _build
    from webp_tpu_torch.ops import enc_tables as k7, wire
    from webp_tpu_torch.ops.enc_params import EncTables

    parent.webp_enc_tables.argtypes = _build._SIGNATURES["webp_enc_tables"]
    parent.webp_wire.argtypes = _build._SIGNATURES["webp_wire"]
    for fn in (parent.webp_enc_tables, parent.webp_wire):
        fn.restype = ctypes.c_int
    parent.webp_error_string.argtypes = [ctypes.c_int]
    parent.webp_error_string.restype = ctypes.c_char_p
    libs = {"package": (lib, dict(_build._entries)),
            "parent": (parent, {"webp_enc_tables": parent.webp_enc_tables})}

    def parent_wire(bitmap, vals, sp_over, meta8, esc_pos, esc_val, overflow):
        B, nmb, _ = vals.shape
        out = torch.empty((B, wire.wire_bytes(nmb)), dtype=torch.uint8, device=dev)
        med_over = torch.zeros(B, dtype=torch.int32, device=dev)
        rc = parent.webp_wire(bitmap.data_ptr(), vals.data_ptr(), meta8.data_ptr(),
                              esc_pos.data_ptr(), esc_val.data_ptr(), sp_over.data_ptr(),
                              overflow.data_ptr(), nmb, B, med_over.data_ptr(), out.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"parent webp_wire: CUDA error {rc}")
        return out

    # K7 first on seeded probabilities (its work does not depend on their
    # values), before the flagship's inputs are made: in this tool K7's
    # device time on the flagship's probabilities has read 3-4x that, for
    # either build, in some processes (not explained; PERF.md section 7).
    rng = np.random.RandomState(SEEDED_PROBS)
    seeded = [("enc_tables_seeded", batch, torch.from_numpy(
        rng.randint(0, 256, (batch, 4, 8, 3, 11)).astype(np.uint8)).to(dev), None)
        for batch in batches]
    out = {batch: {} for batch in batches}
    for k, batch, probs, packed in flagship_jobs(dev, batches, seeded):
        rec = out[batch]
        if k == "wire":
            lv8, meta8, esc_pos, esc_val, over, bitmap, vals, sp_over = packed
            args = (bitmap, vals, sp_over, meta8, esc_pos, esc_val, over)
            fns = {"package": lambda: (wire.wire(*args),), "parent": lambda: (parent_wire(*args),)}
        else:
            tables = lambda: tuple(getattr(k7._enc_tables_kernel(probs), f)
                                   for f in EncTables.FIELDS)
            fns = {"package": tables, "parent": tables}
        got = {}
        for who in ("package", "parent"):
            bind(_build, *libs[who])
            got[who] = fns[who]()
        bind(_build, *libs["package"])
        torch.cuda.synchronize()
        for a, b in zip(got["package"], got["parent"]):
            if not torch.equal(a, b):
                raise AssertionError(f"{k} at batch {batch}: the package differs from the "
                                     "parent")
        r = {"call_ms": {}, "device_ms": {}, "device_all_ms": {}, "graph_ms": {}}
        for who in ("parent", "package", "package", "parent"):
            bind(_build, *libs[who])
            fn = fns[who]
            r["call_ms"].setdefault(who, []).append(cs.time_ms(fn, 20))
            r["device_ms"].setdefault(who, []).append(
                cs.device_total(cs.device_ms(fn, 20, TABLES_WIRE_DEVICE[k.split("_seeded")[0]])))
            r["device_all_ms"].setdefault(who, []).append(
                cs.device_total(cs.device_ms(fn, 20, [""])))
            r["graph_ms"].setdefault(who, []).append(graph_ms(fn))
        bind(_build, *libs["package"])
        rec[k] = r
        text = "; ".join(f"{who} " + ", ".join(
            f"{what} {' / '.join('n/a' if t is None else f'{t:.4f}' for t in r[key][who])}"
            for what, key in (("call", "call_ms"), ("device", "device_ms"),
                              ("device all", "device_all_ms"), ("graph", "graph_ms"))) + " ms"
            for who in ("package", "parent"))
        print(f"batch {batch}: {k}: {text}; outputs equal ({card})", flush=True)
        if probe and k == "wire":
            rec[k]["cycles_per_cta"] = probe_cycles(
                lib, k, batch * (1 + -(-vals.shape[1] // wire.WIRE_MBS)), fns["package"],
                batch, card, reached=True)
        elif probe and k == "enc_tables":
            rec[k]["cycles_per_cta"] = probe_cycles(lib, k, batch * 4, fns["package"], batch,
                                                    card)
    return out


# The lossless split: K9, K10 on the photo's colour transform (size_bits
# 3), K11 at these palette sizes (8, 4, 2 and 1 indices a byte: 12 from the
# palette stream, the others seeded); the flat split: K21 and K22 on the
# flagship's pass-2 levels.  Profiler names: every __global__ function of
# either build whose name holds one of these.
INDEX_COLOURS = (2, 4, 12, 200)
INDEX_SEED = 23
SPLIT_DEVICE = {"subtract_green": ["subtract_green"], "color_transform": ["color_transform"],
                "color_indexing": ["color_indexing"],
                # K21: aa03fa0's three launches and its wrapper's zero fill of vals
                "pack_flat": ["tile_count", "tile_scan", "pack_flat", "FillFunctor"],
                "expand_flat": ["expand_flat"]}
SAME_ARGS_ENTRIES = ("webp_vp8l_subtract_green", "webp_vp8l_color_transform",
                     "webp_vp8l_color_indexing")
# K21's and K22's C entry points since 8e0eae3 (K21's scratch: aa03fa0's
# tile counts, int32 [B, ceil(N / 2048)], with vals zeroed by the caller;
# K22's: 8e0eae3's tile counts, or a later build's kept-zeroed state words).
PARENT_PACK = [_P, _L, _I, _I, _P, _P, _P, _P, _P]
PARENT_EXPAND = [_P, _L, _P, _I, _L, _I, _P, _P, _P]
SCRUB_BYTES = 128 << 20  # --cold: written between timed calls, past the 50 MB L2


def device_sum(fn, reps: int, subs) -> dict:
    """{kernel: mean device ms a call} of fn()'s kernels whose names hold
    one of `subs`, and their sum under "total" (None if the trace holds
    none), from one torch.profiler trace of `reps` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    got = {}
    for event in prof.key_averages():
        if event.self_device_time_total and any(s in event.key for s in subs):
            name = event.key.replace("void ", "").replace("(anonymous namespace)::", "")
            name = name.split("(")[0]
            got[name] = got.get(name, 0.0) + event.self_device_time_total / reps / 1000
    return {**got, "total": sum(got.values()) if got else None}


def lossless_steps(dev, batch: int) -> dict:
    """(name, kernel) -> (wrapper, input, extra args) of the lossless
    phase's streams tiled to `batch`: each transform's input as the
    decode meets it (the stepped kernels' outputs feeding the next), and
    K11 at INDEX_COLOURS (12 from the palette stream, the rest seeded)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from webp_tpu_torch.decode import vp8l_device as ldev
    from webp_tpu_torch.ops import vp8l_device as K

    _, streams = cs.lossless_inputs(WIDTH, HEIGHT)
    ops = {0: ("predictor", K.inverse_predictor_), 1: ("color_transform", K.color_transform_),
           2: ("subtract_green", K.subtract_green_), 3: ("color_indexing", K.color_indexing)}
    steps = {}
    for name, stream in (("photo", streams[0]), ("palette", streams[1])):
        results = ldev.entropy_batch([stream] * batch, WIDTH, HEIGHT)
        sig = ldev.signature(results[0][1], results[0][0].shape[1])
        params = [None if p is None else torch.from_numpy(p).to(dev)
                  for p in ldev.stack_params(results, list(range(batch)), sig, HEIGHT)]
        px = torch.from_numpy(np.stack([r[0] for r in results])).to(dev)
        for (ttype, size_bits, table_size), param in zip(reversed(sig[:-1]), reversed(params)):
            kname, kernel = ops[ttype]
            extra = {0: (param, size_bits), 1: (param, size_bits), 2: (),
                     3: (param, table_size, WIDTH)}[ttype]
            steps[(name, kname)] = (kernel, px, extra)
            px = kernel(px.clone(), *extra)
    rng = np.random.RandomState(INDEX_SEED)
    out = {("photo", "subtract_green"): steps[("photo", "subtract_green")],
           ("photo", "color_transform"): steps[("photo", "color_transform")]}
    for colours in INDEX_COLOURS:
        if colours == cs.LOSSLESS_COLOURS:
            out[(f"{colours} colours", "color_indexing")] = steps[("palette", "color_indexing")]
            continue
        pw = K.subsample(WIDTH, K.pack_bits(colours))
        px = rng.randint(0, 256, (batch, HEIGHT, pw, 4)).astype(np.uint8)
        if K.pack_bits(colours) == 0:
            px[..., 1] = rng.randint(0, colours, (batch, HEIGHT, pw))
        table = np.zeros((batch, 256, 4), np.uint8)
        table[:, :colours] = rng.randint(0, 256, (batch, colours, 4))
        out[(f"{colours} colours", "color_indexing")] = (
            K.color_indexing, torch.from_numpy(px).to(dev),
            (torch.from_numpy(table).to(dev), colours, WIDTH))
    return out


def split_bound(kname: str, inp, extra, batch: int) -> dict:
    """chip_smoke's bound of a lossless kernel on these inputs."""
    import chip_smoke as cs

    npx = inp.shape[0] * inp.shape[1] * inp.shape[2]
    if kname == "subtract_green":
        return cs.bound(2 * cs.nbytes(inp), npx * 8)
    if kname == "color_transform":
        return cs.bound(2 * cs.nbytes(inp) + cs.nbytes(extra[0]), npx * 25)
    return cs.bound(cs.nbytes(inp, extra[0]) + batch * HEIGHT * WIDTH * 4,
                    batch * HEIGHT * WIDTH * 8)


def turns(libs, k: str, batch: int, fns: dict, subs, bound: dict, card: str) -> dict:
    """fns[who]() of each build in turns (parent, package, package,
    parent): call by CUDA events, device time of the kernels named `subs`
    (the profiler), every device op, and a CUDA graph of 20 calls; the
    share of the bound from the median device time."""
    import chip_smoke as cs
    from webp_tpu_torch import _build

    r = {"call_ms": {}, "device_ms": {}, "device_all_ms": {}, "graph_ms": {}, "kernels": {}}
    for who in ("parent", "package", "package", "parent"):
        bind(_build, *libs[who])
        fn = fns[who]
        r["call_ms"].setdefault(who, []).append(cs.time_ms(fn, 20))
        per = device_sum(fn, 20, subs)
        r["device_ms"].setdefault(who, []).append(per.pop("total"))
        r["kernels"].setdefault(who, []).append(per)
        r["device_all_ms"].setdefault(who, []).append(
            cs.device_total(cs.device_ms(fn, 20, [""])))
        r["graph_ms"].setdefault(who, []).append(graph_ms(fn))
    bind(_build, *libs["package"])
    r.update(bound)
    r["share_of_bound"] = {who: bound["bound_ms"] / statistics.median(ts)
                           for who, ts in r["device_ms"].items() if None not in ts}
    text = "; ".join(f"{who} " + ", ".join(
        f"{what} {' / '.join('n/a' if t is None else f'{t:.4f}' for t in r[key][who])}"
        for what, key in (("call", "call_ms"), ("device", "device_ms"),
                          ("device all", "device_all_ms"), ("graph", "graph_ms"))) + " ms"
        + f" (kernels {r['kernels'][who][0]})" for who in ("package", "parent"))
    share = ", ".join(f"{who} {s:.0%}" for who, s in r["share_of_bound"].items())
    print(f"batch {batch}: {k}: {text}; bound {bound['bound_ms']:.4f} ms by "
          f"{bound['bound_by']}, share of bound {share}; outputs equal ({card})", flush=True)
    return r


_scrub = []


def scrubbed(fn):
    """fn() after a write of SCRUB_BYTES (add_, not a kernel that `subs`
    names): the 50 MB L2 then holds none of fn's inputs."""
    import torch

    if not _scrub:
        _scrub.append(torch.zeros(SCRUB_BYTES, dtype=torch.uint8, device="cuda"))

    def call():
        _scrub[0].add_(1)
        return fn()
    return call


def cold_turns(libs, k: str, batch: int, fns: dict, subs, bound: dict, card: str) -> dict:
    """The device time of fns[who]()'s kernels named `subs` (the profiler)
    with the inputs cold, each call after the scrub, in turns (parent,
    package, package, parent); the share of the bound."""
    from webp_tpu_torch import _build

    r = {"device_ms": {}}
    for who in ("parent", "package", "package", "parent"):
        bind(_build, *libs[who])
        r["device_ms"].setdefault(who, []).append(device_sum(scrubbed(fns[who]), 20, subs)["total"])
    bind(_build, *libs["package"])
    r["share_of_bound"] = {who: bound["bound_ms"] / statistics.median(ts)
                           for who, ts in r["device_ms"].items() if None not in ts}
    text = "; ".join(f"{who} {' / '.join(f'{t:.4f}' for t in r['device_ms'][who])} ms"
                     for who in ("package", "parent"))
    share = ", ".join(f"{who} {s:.0%}" for who, s in r["share_of_bound"].items())
    print(f"batch {batch}: {k} cold (a {SCRUB_BYTES >> 20} MB write before each call): device "
          f"{text}; bound {bound['bound_ms']:.4f} ms by {bound['bound_by']}, share of bound "
          f"{share} ({card})", flush=True)
    return r


def same_args_libs(lib, parent):
    """The two builds' bindings of K9-K11, whose C entry points take the
    same arguments in both."""
    from webp_tpu_torch import _build

    for name in SAME_ARGS_ENTRIES:
        getattr(parent, name).argtypes = _build._SIGNATURES[name]
        getattr(parent, name).restype = ctypes.c_int
    parent.webp_error_string.argtypes = [ctypes.c_int]
    parent.webp_error_string.restype = ctypes.c_char_p
    return {"package": (lib, dict(_build._entries)),
            "parent": (parent, {n: getattr(parent, n) for n in SAME_ARGS_ENTRIES})}


def split_vp8l(dev, card: str, batches, lib, parent, probe: bool, cold: bool) -> dict:
    """K9, K10 and K11 (four packings) of the package beside the parent's,
    through the package's wrappers with either library bound, in turns,
    per batch; outputs checked equal first (the in-place kernels on fresh
    copies; timed in place on one copy); with `cold`, K11 at 200 colours
    again with its inputs cold."""
    import torch

    from webp_tpu_torch import _build
    from webp_tpu_torch.ops import vp8l_device as K

    libs = same_args_libs(lib, parent)
    out = {}
    for batch in batches:
        rec = {}
        for (name, kname), (kernel, inp, extra) in lossless_steps(dev, batch).items():
            got = {}
            for who in ("package", "parent"):
                bind(_build, *libs[who])
                got[who] = kernel(inp.clone(), *extra)
            bind(_build, *libs["package"])
            torch.cuda.synchronize()
            if not torch.equal(got["package"], got["parent"]):
                raise AssertionError(f"{kname} ({name}) at batch {batch}: the package differs "
                                     "from the parent")
            work = inp.clone()
            fn = (lambda: kernel(inp, *extra)) if kname == "color_indexing" else (
                lambda: kernel(work, *extra))
            key = f"{kname} ({name})"
            rec[key] = turns(libs, key, batch, {"package": fn, "parent": fn},
                             SPLIT_DEVICE[kname], split_bound(kname, inp, extra, batch), card)
            if cold and name == "200 colours":
                rec[key]["cold"] = cold_turns(libs, key, batch, {"package": fn, "parent": fn},
                                              SPLIT_DEVICE[kname],
                                              split_bound(kname, inp, extra, batch), card)
            if probe and kname == "color_indexing":
                ctas = batch * -(-HEIGHT // K.index_rows(WIDTH, HEIGHT))
                rec[key]["cycles_per_cta"] = probe_cycles(lib, "color_indexing", ctas, fn, batch,
                                                          card, source="vp8l")
        out[batch] = rec
    return out


def split_sparse(dev, card: str, batches, lib, parent, parent_csrc: Path, probe: bool,
                 cold: bool) -> dict:
    """K21 and K22 of the package beside the parent's on the flagship's
    pass-2 levels (K18's lv8, flattened: N = 614,400 slots an image, cap =
    cap_for(1536)), in turns, per batch; the package's through its
    wrappers, the parent's through its C entry points with a scratch made
    zero once (aa03fa0's K21 overwrites it with its tile counts and needs
    vals zeroed, as its wrapper did; a one-launch K21, whose source has no
    tile_count_kernel, leaves it zero and writes every byte of vals; K22's
    scratch: 8e0eae3's tile counts or a later build's state words).
    Outputs checked equal, K22's at n = N and N - 5; with `cold`, the
    device times again with the inputs cold."""
    import torch

    import chip_smoke as cs
    from webp_tpu_torch import _build
    from webp_tpu_torch.ops import sparse, wire

    libs = same_args_libs(lib, parent)
    parent.webp_pack_flat.argtypes = PARENT_PACK
    parent.webp_expand_flat.argtypes = PARENT_EXPAND
    parent.webp_pack_flat.restype = parent.webp_expand_flat.restype = ctypes.c_int

    one_launch = "tile_count_kernel" not in (parent_csrc / "sparse.cu").read_text()
    scratch = {}

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def parent_pack(flat, cap):
        B, N = flat.shape
        bitmap = torch.empty((B, N // 8), dtype=torch.uint8, device=dev)
        vals = (torch.empty if one_launch else torch.zeros)((B, cap), dtype=torch.int8, device=dev)
        over = torch.empty(B, dtype=torch.bool, device=dev)
        if B not in scratch:  # int32 [B, ceil(N / 2048)] or int64 [B + B * ceil(N / 8192)]
            scratch[B] = torch.zeros(B * (1 + -(-N // 2048)), dtype=torch.int64, device=dev)
        rc = parent.webp_pack_flat(flat.data_ptr(), N, B, cap, scratch[B].data_ptr(),
                                   bitmap.data_ptr(), vals.data_ptr(), over.data_ptr(), stream())
        if rc:
            raise RuntimeError(f"parent webp_pack_flat: CUDA error {rc}")
        return bitmap, vals, over

    def parent_expand(bitmap, vals, n):
        B, nb = bitmap.shape
        out = torch.empty((B, n), dtype=torch.int8, device=dev)
        tiles = torch.zeros(B * (1 + -(-n // 2048)), dtype=torch.int64, device=dev)
        rc = parent.webp_expand_flat(bitmap.data_ptr(), nb, vals.data_ptr(), vals.shape[1], n, B,
                                     tiles.data_ptr(), out.data_ptr(), stream())
        if rc:
            raise RuntimeError(f"parent webp_expand_flat: CUDA error {rc}")
        return out

    out = {}
    for batch in batches:
        *_, pass2 = encode_inputs(dev, batch, pass2=True)
        lv8 = wire.prepack(pass2)[0]
        N = lv8.shape[1] * lv8.shape[2]
        lv8 = lv8.reshape(batch, N).contiguous()
        cap = sparse.cap_for(lv8.shape[1] // wire.SLOTS)
        got = {"package": sparse.pack_levels(lv8, cap), "parent": parent_pack(lv8, cap)}
        bitmap, vals, over = got["package"]
        for n in (N, N - 5):
            got[f"package {n}"] = sparse.expand_levels(bitmap, vals, n)
            got[f"parent {n}"] = parent_expand(bitmap, vals, n)
        torch.cuda.synchronize()
        if over.any() or not all(map(torch.equal, got["package"], got["parent"])) or not all(
                torch.equal(got[f"package {n}"], got[f"parent {n}"]) for n in (N, N - 5)):
            raise AssertionError(f"flat sparse at batch {batch}: the package differs from the "
                                 "parent, or the levels overflow the cap")
        if not torch.equal(got[f"package {N}"], lv8):
            raise AssertionError(f"flat sparse at batch {batch}: the round trip differs")
        count = int((lv8 != 0).sum())
        bounds = {"pack_flat": cs.bound(cs.nbytes(lv8, bitmap, vals, over),
                                        batch * N * cs.OPS_FLAT_SLOT),
                  "expand_flat": cs.bound(cs.nbytes(lv8, bitmap) + count,
                                          batch * N * cs.OPS_FLAT_SLOT)}
        fns = {"pack_flat": {"package": lambda: sparse.pack_levels(lv8, cap),
                             "parent": lambda: parent_pack(lv8, cap)},
               "expand_flat": {"package": lambda: sparse.expand_levels(bitmap, vals, N),
                               "parent": lambda: parent_expand(bitmap, vals, N)}}
        rec = {k: turns(libs, k, batch, f, SPLIT_DEVICE[k], bounds[k], card)
               for k, f in fns.items()}
        if cold:
            for k, f in fns.items():
                rec[k]["cold"] = cold_turns(libs, k, batch, f, SPLIT_DEVICE[k], bounds[k], card)
        if probe:
            ctas = batch * (-(-N // sparse.FLAT_TILE) + 8)  # K21: at most a CTA a ticket
            for k, f in fns.items():
                rec[k]["cycles_per_cta"] = probe_cycles(lib, k, ctas, f["package"], batch, card,
                                                        reached=True, source="sparse")
        out[batch] = rec
    return out


def wire_probe_cycles(lib, k: str, ctas: int, fn, batch: int, card: str) -> dict:
    """Mean cycles a CTA (its thread 0) by phase of wire kernel k over one
    call of fn(), from the clocks its probes stored (WIRE_PHASES)."""
    import torch

    reader = lib.webp_wire_probe
    reader.argtypes, reader.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    n = N_PROBE * ctas
    buf = (ctypes.c_longlong * n)()
    reader(buf, n)  # read and zero
    fn()
    torch.cuda.synchronize()
    if reader(buf, n) != 0:
        raise RuntimeError("the probe read failed")
    slots = WIRE_PHASES[k]
    cyc = {}
    for (_, a), (ph, b) in zip(slots, slots[1:]):
        cyc[ph] = statistics.mean(buf[c * N_PROBE + b] - buf[c * N_PROBE + a] for c in range(ctas))
    cyc["total"] = sum(cyc.values())
    print(f"batch {batch}: {k} probe, mean cycles a CTA by phase "
          f"{({p: round(c) for p, c in cyc.items()})} ({card})", flush=True)
    return cyc


def sass_local(lib_path: Path, kernels) -> list:
    """Per kernel of `kernels` (a substring of its SASS function name), the
    local-memory loads and stores (LDL / STL) in the library's SASS."""
    from webp_tpu_torch import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, on = {k: [0, 0] for k in kernels}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            # the longest name that fits: prepack_pack_kernel before prepack_kernel
            on = max((k for k in kernels if k in fn), key=len, default=None)
        elif on is not None:
            counts[on][0] += " LDL" in line
            counts[on][1] += " STL" in line
    return [f"{k}: {ldl} LDL, {stl} STL in the SASS" for k, (ldl, stl) in counts.items()]


def launch_profile(dev, card: str, reps: int = 2000, rounds: int = 3) -> dict:
    """The launch path's host work per call, step by step, the earlier path
    against the current one; then K9's call through each beside one add_."""
    import time

    import torch

    import chip_smoke as cs
    from webp_tpu_torch import _build
    from webp_tpu_torch.ops import vp8l_device as L

    lib = _build.load()
    entry = "webp_vp8l_subtract_green"

    def earlier_launch(kernel, name, device, *args):  # the path before its cut, step by step
        with _build._lock:
            lib_ = _build._lib
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = getattr(lib_, name)(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
        _build.LAUNCHES[kernel] += 1

    def earlier_sg(px):
        B, h, w = L._pixels(px)
        earlier_launch("subtract_green", entry, px.device, px.data_ptr(), B * h * w)
        return px

    def lock():
        with _build._lock:
            pass

    def context():
        with torch.cuda.device(dev):
            pass

    tiny = torch.zeros((1, 1, 8, 4), dtype=torch.uint8, device=dev)
    ptr, fn = tiny.data_ptr(), _build._entries[entry]
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    steps = {
        "earlier: lock of load()": lock,
        "earlier: torch.cuda.device context": context,
        "earlier: current_stream(dev).cuda_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "earlier: getattr of the entry": lambda: getattr(lib, entry),
        "current: entry dict lookup": lambda: _build._entries.get(entry),
        "current: torch.cuda.current_device()": torch.cuda.current_device,
        "current: raw current-stream query": lambda: torch._C._cuda_getCurrentRawStream(
            dev.index),
        "ctypes call alone (a launch)": lambda: fn(ptr, 8, stream),
        "K9 wrapper check (_pixels)": lambda: L._pixels(tiny),
        "earlier launch path": lambda: earlier_launch("subtract_green", entry, dev, ptr, 8),
        "current launch path": lambda: _build.launch("subtract_green", entry, dev, ptr, 8),
        "earlier K9 call": lambda: earlier_sg(tiny),
        "current K9 call": lambda: L.subtract_green_(tiny),
    }
    us = {k: [] for k in steps}
    for _ in range(rounds):
        for k, step in steps.items():
            step()
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            for _ in range(reps):
                step()
            us[k].append((time.perf_counter_ns() - t0) / reps / 1000)
            torch.cuda.synchronize()
    for k, v in us.items():
        print(f"launch path: {k}: {' / '.join(f'{x:.3f}' for x in v)} us a call ({card})",
              flush=True)

    g = torch.Generator().manual_seed(9)
    px = torch.randint(0, 256, (8, HEIGHT, WIDTH, 4), generator=g, dtype=torch.uint8).to(dev)
    calls = {"K9 earlier path": lambda: earlier_sg(px), "K9 current path": lambda: L.subtract_green_(px),
             "add_": lambda: px[..., 0:3:2].add_(px[..., 1:2])}
    k9 = {k: {"call_ms": [], "device_ms": []} for k in calls}
    for _ in range(rounds):
        for k in ("K9 earlier path", "K9 current path", "add_", "add_", "K9 current path",
                  "K9 earlier path"):
            k9[k]["call_ms"].append(cs.time_ms(calls[k], 20))
            k9[k]["device_ms"].append(cs.device_total(cs.device_ms(calls[k], 20, [""])))
    for k, r in k9.items():
        print(f"subtract_green on 8 x {WIDTH}x{HEIGHT}: {k}: call "
              f"{' / '.join(f'{x:.4f}' for x in r['call_ms'])} ms (median "
              f"{statistics.median(r['call_ms']):.4f}), device "
              f"{' / '.join('n/a' if x is None else f'{x:.4f}' for x in r['device_ms'])} ms "
              f"({card})", flush=True)
    return {"steps_us": us, "k9": k9}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", action="store_true", help="device-time ranking of the flagship's "
                    "unredesigned kernels")
    ap.add_argument("--launch", action="store_true", help="the launch path's host work, and K9 "
                    "beside add_")
    ap.add_argument("--csrc", type=Path, help="an earlier csrc whose kernels to time beside")
    ap.add_argument("--split", default="residual,yuv2rgb",
                    help="the kernels --csrc times: residual,yuv2rgb, analysis,token_stats, "
                    "prepack,pack_levels, wire,enc_tables, vp8l, sparse or vp8l,sparse")
    ap.add_argument("--probe", action="store_true", help="clock64() probes per phase")
    ap.add_argument("--cold", action="store_true", help="with --split vp8l / sparse, also time "
                    "K11 at 200 colours, K21 and K22 with a 128 MB write before each call")
    ap.add_argument("--segs", help="also time K8 / K6 with CTAs of these MBs a row")
    ap.add_argument("--batches", default="8,64", help="batch sizes, comma-separated")
    ap.add_argument("--out", type=Path, help="also write the numbers to this JSON file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("stats_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    from webp_tpu_torch import _build
    from webp_tpu_torch.io import native

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    native.load()
    package_csrc = _build.CSRC
    parent = None
    if args.csrc:
        parent = build(_build, args.csrc.resolve(), ROOT / "build" / "stats_split" / "parent",
                       bind=False)
        parent_ptxas = ptxas_lines(_build.PTXAS_REPORT)
        parent_lib = _build.LIB_PATH
    lib = build(_build, package_csrc, ROOT / "build" / "stats_split" / "package", args.probe)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    batches = [int(b) for b in args.batches.split(",")]
    out = {"card": card, "ptxas": ptxas_lines(_build.PTXAS_REPORT)}
    if args.launch:
        out["launch"] = launch_profile(dev, card)
    if parent is not None:
        out["parent_ptxas"] = parent_ptxas
        split = args.split.split(",")
        if split == ["residual", "yuv2rgb"]:
            out["split"] = split_decode(dev, card, batches, lib, parent, args.probe)
        elif split == ["analysis", "token_stats"]:
            out["split"] = split_stats(dev, card, batches, lib, parent, args.probe,
                                       [int(x) for x in args.segs.split(",")] if args.segs
                                       else ())
        elif split == ["wire", "enc_tables"]:
            out["split"] = split_tables_wire(dev, card, batches, lib, parent, args.probe)
            out["sass"] = sass_local(_build.LIB_PATH, ("wire_kernel", "enc_tables_kernel"))
            out["parent_sass"] = sass_local(parent_lib, ("wire_mb_kernel", "wire_list_kernel",
                                                         "enc_tables_kernel"))
        elif set(split) <= {"vp8l", "sparse"}:
            out["split"] = {}
            if "vp8l" in split:
                out["split"]["vp8l"] = split_vp8l(dev, card, batches, lib, parent, args.probe,
                                                  args.cold)
            if "sparse" in split:
                out["split"]["sparse"] = split_sparse(dev, card, batches, lib, parent,
                                                      args.csrc.resolve(), args.probe, args.cold)
            flat = ("color_indexing", "expand_flat", "pack_flat", "tile_count", "tile_scan")
            out["sass"] = sass_local(_build.LIB_PATH, flat)
            out["parent_sass"] = sass_local(parent_lib, flat)
        elif split == ["prepack", "pack_levels"]:
            out["split"] = split_wire(dev, card, batches, lib, parent, args.probe)
            out["sass"] = sass_local(_build.LIB_PATH, ("prepack_pack_kernel", "prepack_kernel",
                                                       "pack_levels_kernel"))
            out["parent_sass"] = sass_local(parent_lib, ("prepack_kernel", "pack_levels_kernel"))
        else:
            raise SystemExit(f"--split {args.split}: residual,yuv2rgb, analysis,token_stats, "
                             "prepack,pack_levels, wire,enc_tables, vp8l, sparse or vp8l,sparse")
    if args.rank:
        out["rank"] = rank(dev, card, batches)
    for who in ("ptxas", "parent_ptxas", "sass", "parent_sass"):
        for line in out.get(who, []):
            print(f"{who} {line}")
    print(smi)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

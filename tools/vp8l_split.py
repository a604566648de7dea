#!/usr/bin/env python3
"""Time kernel K12, the VP8L inverse predictor (`webp_tpu_torch/csrc/vp8l.cu`),
in its versions, and where a pixel step goes, on one NVIDIA GPU.

    python3 tools/vp8l_split.py [--csrc DIR] [--probe] [--only NAMES] [--out FILE]

Inputs are `chip_smoke.py`'s lossless streams at 768x512: the photo
([subtract-green, predictor 2, colour 3]) and the 12-colour palette image
([palette, predictor 2], the predictor on the 384-wide packed image); the
host entropy pass and the plain twins of the transforms after K12 give
K12's own residuals and modes, tiled to a batch of 8.  The script copies
`vp8l.cu` and `common.cuh` of each version into `build/vp8l_split/<name>/`
and builds them all at once with nvcc (`-Xptxas -v`), one shared library
each, loaded with ctypes:

- `rows`: the package's row-band kernel;
- `switch`: the same with the one-block kernel's per-channel `switch` predictor in place
  of the branch-free select tree;
- `scalar`: the select tree with Select and the two clamped modes computed
  per channel in plain integer code instead of on 16-bit fields;
- `fields`: the two clamped modes on biased 16-bit fields in plain integer
  operations instead of the SIMD intrinsics `__vadd2`, `__vsub2`,
  `__vmaxs2`, `__vmins2`;
- `no_predict` (a diagnostic, not exact): every pixel predicted from its
  top neighbour, the step without the predictor's arithmetic;
- `unrolled`: the chunk's four sub-chunks unrolled too (32 steps of code);
- `sleep100`: the compute warps' waits sleep 100 ns a poll instead of 20;
- `lag10`, `lag12`: a band trails the band above by 10 or 12 sub-chunks
  instead of 8;
- `spread`: a sub-chunk's tile stages one row a step, between the steps,
  instead of all eight rows after the wait;
- `direct_store`: each lane stores its output to the image at its step
  (32 rows an instruction) instead of the tile's coalesced store-back;
- `no_stage`, `no_fetch` (diagnostics, not exact): without the tile
  stages (the steps read stale tiles), or without the copies of the next
  chunks, to show what each costs;
- `no_fence` (a diagnostic, exact only by the hardware's in-order shared
  memory): the shared counters and edge rings volatile, with no
  `__threadfence_block()`, to show what the CTA-scope fences cost;
- `one_block`, with --csrc DIR: DIR's `vp8l.cu` (the one-block-per-image
  kernel of commit 1324f04: `git archive 1324f04 webp_tpu_torch/csrc |
  tar -x -C build/vp8l_parent` gives DIR =
  build/vp8l_parent/webp_tpu_torch/csrc).

Each version runs on the photo and the packed image at batch 8 and 1
(CUDA events, the median of ten launches on a fresh copy of the input),
is checked against the plain twin (the exact versions must equal it), and
on one 32-row band at widths 2048 and 8192, whose difference over the
6,144 steps between them is one pixel step.  It prints ptxas's registers,
shared memory and spills for each, and the number of SASS instructions in
its K12 kernel (`cuobjdump -sass`, kept beside the library), with the
card's name and power limit.

--probe adds `clock64()` probes (text patches at anchors of the sources;
the script stops at an anchor not found exactly once): in `rows`, lane 0
of every band sums over its chunks the cycles of the chunk's start (the
wait for its copies, the mode rows, its counters), its waits for the row
above with the edge loads, and the chunk's 32 steps (with the tile stages)
without those waits, and once the last chunk's store-back; and
stamps (`%globaltimer`) image 0's bands: their start after the first wait,
their end, each chunk's start, and the first eight sub-chunks' end of wait
with the polls it slept.  In `one_block` (with --csrc), thread 0 sums over the wavefront steps its own work, its wait at the
block barrier and the slowest thread's work of each step.
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
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v"]
STEP_WIDTHS = (2048, 8192)
ROWS_PHASES = ("chunk_start", "wait_above", "steps", "tail")
# acc[4], acc[5], acc[6]: globaltimer ns at a band's start, end, and after its first wait
OLD_PHASES = ("work", "barrier", "slowest_work")

SWITCH_PREDICT = """
__device__ __forceinline__ int chan(uint32_t p, int c) { return (p >> (8 * c)) & 0xff; }
__device__ __forceinline__ int avg2i(int a, int b) { return (a + b) >> 1; }

// The one-block kernel's predictor: a switch on the mode, per channel where it must.
__device__ uint32_t predict_switch(int mode, uint32_t L, uint32_t T, uint32_t TL, uint32_t TR) {
    switch (mode) {
    case 0: return 0xff000000u;
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 11: {
        int pl = 0, pt = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int p = chan(L, c) + chan(T, c) - chan(TL, c);
            pl += abs(p - chan(L, c));
            pt += abs(p - chan(T, c));
        }
        return pl < pt ? L : T;
    }
    default: break;
    }
    if (mode > 13) return 0;
    uint32_t out = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const int l = chan(L, c), t = chan(T, c), tl = chan(TL, c), tr = chan(TR, c);
        int v;
        switch (mode) {
        case 5: v = avg2i(avg2i(l, tr), t); break;
        case 6: v = avg2i(l, tl); break;
        case 7: v = avg2i(l, t); break;
        case 8: v = avg2i(tl, t); break;
        case 9: v = avg2i(t, tr); break;
        case 10: v = avg2i(avg2i(l, tl), avg2i(t, tr)); break;
        case 12: v = clip255(l + t - tl); break;
        default: {  // 13
            const int a = avg2i(l, t), d = a - tl;
            v = clip255(a + (d >= 0 ? d >> 1 : -((-d) >> 1)));
        }
        }
        out |= static_cast<uint32_t>(v) << (8 * c);
    }
    return out;
}

"""
STAGE_SPAN = ("            // Rows kSub * q .. + kSub - 1", "            // The lane's residuals and modes")
SELECT_ANCHOR = "__device__ __forceinline__ uint32_t predict_select("
PREDICT_CALL = "predict_select(m, h1, T, TL, TR)"
SWAR_SPECIAL = (
    "    // Select: L when sum |T - TL| < sum |L - TL|.\n",
    "    const bool b0 = mode & 1,",
)
FIELDS_SPECIAL = """    // Select: L when sum |T - TL| < sum |L - TL|.
    const uint32_t p11 = __vsadu4(T, TL) < __vsadu4(L, TL) ? L : T;
    const uint32_t p12 =
        clamp_add_sub_full(L & kEven, T & kEven, TL & kEven) |
        clamp_add_sub_full((L >> 8) & kEven, (T >> 8) & kEven, (TL >> 8) & kEven) << 8;
    const uint32_t p13 = clamp_add_sub_half(p7 & kEven, TL & kEven) |
                         clamp_add_sub_half((p7 >> 8) & kEven, (TL >> 8) & kEven) << 8;
"""
FIELDS_HELPERS = """
constexpr uint32_t kBias = 0x01000100u;  // 256 in each field
constexpr uint32_t kOnes = 0x00010001u;

// clip255(f - 256) of each field f in [0, 767], in plain integer operations.
__device__ __forceinline__ uint32_t clip_biased(uint32_t f) {
    const uint32_t over = (f >> 9) & kOnes;
    const uint32_t in = (f >> 8) & kOnes & ~over;
    return (f & kEven & ((in << 8) - in)) | ((over << 8) - over);
}

__device__ __forceinline__ uint32_t clamp_add_sub_full(uint32_t l, uint32_t t, uint32_t tl) {
    return clip_biased(l + t + kBias - tl);
}

__device__ __forceinline__ uint32_t clamp_add_sub_half(uint32_t a, uint32_t tl) {
    const uint32_t u = a + kBias - tl;
    const uint32_t neg = (~u >> 8) & kOnes;
    const uint32_t half = ((u + neg) >> 1) & kEven;
    return clip_biased(a + half + 0x00800080u);
}

"""
SCALAR_SPECIAL = """    uint32_t p11, p12 = 0, p13 = 0;
    {
        int pl = 0, pt = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int l = (L >> 8 * c) & 0xff, t = (T >> 8 * c) & 0xff, tl = (TL >> 8 * c) & 0xff;
            pl += abs(t - tl);
            pt += abs(l - tl);
            p12 |= static_cast<uint32_t>(clip255(l + t - tl)) << 8 * c;
            const int a = (l + t) >> 1, d = a - tl;
            p13 |= static_cast<uint32_t>(clip255(a + (d >= 0 ? d >> 1 : -((-d) >> 1)))) << 8 * c;
        }
        p11 = pl < pt ? L : T;
    }
"""

ROWS_PROBE_DECL = """
constexpr int kProbeBands = 1 << 14;
__device__ long long k12_probe[kProbeBands * 8];
#define PROBE(k) do { const long long t_ = clock64(); acc[k] += t_ - tp; tp = t_; } while (0)
__device__ long long k12_stamps[kProbeBands * 64];  // image 0's bands: each chunk's start (ns)
__device__ long long k12_subs[kProbeBands * 16];    // image 0's bands, chunks 0-1: (after the wait, polls) a sub-chunk
__device__ __forceinline__ long long global_ns() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
"""
ROWS_PATCHES = [
    ("constexpr unsigned kFull = 0xffffffffu;\n",
     "constexpr unsigned kFull = 0xffffffffu;\n" + ROWS_PROBE_DECL),
    ("    for (int c = 0; c < n_chunks; ++c) {\n",
     "    long long acc[8] = {};\n    long long tp = clock64();\n"
     "    acc[4] = acc[6] = global_ns();\n"
     "    for (int c = 0; c < n_chunks; ++c) {\n"),
    ("        load_modes(c + 3);\n        __syncwarp();\n",
     "        load_modes(c + 3);\n        __syncwarp();\n        ++acc[7];\n"
     "        if (lane == 0 && b == 0 && c < 64) k12_stamps[(j * kWarps + k) * 64 + c] = global_ns();\n"),
    ("        for (int q = 0; q < kChunk / kSub; ++q) {\n",
     "        PROBE(0);\n        for (int q = 0; q < kChunk / kSub; ++q) {\n"),
    ("                const int need = min(w, sq + kSub * (kLag + 1) - kSpan);\n"
     "                while (ld_shared_volatile(&S.made[k]) < need) __nanosleep(20);\n",
     "                const long long tw_ = clock64();\n"
     "                const int need = min(w, sq + kSub * (kLag + 1) - kSpan);\n"
     "                int polls_ = 0;\n"
     "                while (ld_shared_volatile(&S.made[k]) < need) { __nanosleep(20); ++polls_; }\n"
     "                if (b == 0 && sq < 64) {\n"
     "                    k12_subs[((j * kWarps + k) * 8 + sq / 8) * 2] = global_ns();\n"
     "                    k12_subs[((j * kWarps + k) * 8 + sq / 8) * 2 + 1] = polls_;\n"
     "                }\n"),
    ("                for (int t = 0; t < kSub; ++t) ev[t] = ein[(sq + 1 + t) & (kEdgeRing - 1)];\n",
     "                for (int t = 0; t < kSub; ++t) ev[t] = ein[(sq + 1 + t) & (kEdgeRing - 1)];\n"
     "                acc[1] += clock64() - tw_;\n"
     "                if (sq == 0) acc[6] = global_ns();\n"),
    ("                h1 = out;\n            }\n        }\n        cp_async_commit();\n    }\n",
     "                h1 = out;\n            }\n        }\n        PROBE(2);\n        cp_async_commit();\n    }\n"),
    ("        if (inside(xb, i)) img[(y0 + i) * w + xb] = tile[i * kStride + (xb & (kRing - 1))];\n"
     "    }\n}\n",
     "        if (inside(xb, i)) img[(y0 + i) * w + xb] = tile[i * kStride + (xb & (kRing - 1))];\n"
     "    }\n    PROBE(3);\n    acc[5] = global_ns();\n    if (lane == 0) {\n"
     "        const int ticket = b * a.bands + j;  // image-major: image 0's bands first\n"
     "        for (int p = 0; p < 8; ++p)\n"
     "            k12_probe[((ticket * kWarps + k) % kProbeBands) * 8 + p] = acc[p];\n"
     "    }\n}\n"),
]
OLD_PROBE_DECL = """
__device__ long long k12_probe[4096 * 4];
"""
OLD_PATCHES = [
    ("#include \"common.cuh\"\n", "#include \"common.cuh\"\n" + OLD_PROBE_DECL),
    ("    for (int t = 0; t < steps; ++t) {\n",
     "    __shared__ unsigned long long probe_max[3];\n"
     "    long long acc[3] = {0, 0, 0};\n"
     "    if (threadIdx.x < 3) probe_max[threadIdx.x] = 0;\n"
     "    __syncthreads();\n"
     "    for (int t = 0; t < steps; ++t) {\n"
     "        const long long t_start = clock64();\n"),
    ("        __syncthreads();\n    }\n}\n",
     "        const long long t_work = clock64();\n"
     "        atomicMax(&probe_max[t % 3], static_cast<unsigned long long>(t_work - t_start));\n"
     "        __syncthreads();\n"
     "        if (threadIdx.x == 0) {\n"
     "            acc[0] += t_work - t_start;\n"
     "            acc[1] += clock64() - t_work;\n"
     "            acc[2] += probe_max[t % 3];\n"
     "            probe_max[(t + 2) % 3] = 0;\n"
     "        }\n"
     "    }\n"
     "    if (threadIdx.x == 0) {\n"
     "        for (int p = 0; p < 3; ++p) k12_probe[b * 4 + p] = acc[p];\n"
     "        k12_probe[b * 4 + 3] = steps;\n"
     "    }\n}\n"),
]


def patch(src: str, patches) -> str:
    for anchor, replacement in patches:
        n = src.count(anchor)
        if n != 1:
            raise SystemExit(f"anchor found {n} times, not once: {anchor[:60]!r}")
        src = src.replace(anchor, replacement)
    return src


def versions(package_src: str, old_src: str | None, probe: bool) -> dict:
    """name -> (vp8l.cu text, whether its output must equal the twin)."""
    switch = patch(package_src, [(SELECT_ANCHOR, SWITCH_PREDICT + SELECT_ANCHOR),
                                 (PREDICT_CALL, PREDICT_CALL.replace("predict_select",
                                                                     "predict_switch"))])
    start = package_src.index(SWAR_SPECIAL[0])
    end = package_src.index(SWAR_SPECIAL[1])
    scalar = package_src[:start] + SCALAR_SPECIAL + package_src[end:]
    fields = patch(package_src[:start] + FIELDS_SPECIAL + package_src[end:],
                   [(SELECT_ANCHOR, FIELDS_HELPERS + SELECT_ANCHOR)])
    no_fence = patch(package_src, [
        ("    __threadfence_block();\n    *static_cast<volatile int*>(p) = v;",
         "    *static_cast<volatile int*>(p) = v;"),
        ("                __threadfence_block();\n                if (sq == 0) te = ein[0];",
         "                if (sq == 0) te = ein[0];"),
        ("    const uint32_t* ein = S.edge[k];", "    const volatile uint32_t* ein = S.edge[k];"),
        ("    uint32_t* eout = S.edge[k + 1];", "    volatile uint32_t* eout = S.edge[k + 1];")])
    a = package_src.index(STAGE_SPAN[0])
    no_stage = package_src[:a] + package_src[package_src.index(STAGE_SPAN[1]):]
    direct = patch(package_src, [
        ("                if (c > 0 && inside(xb, r)) img[(y0 + r) * w + xb] = back[t];\n", ""),
        ("                if (on) tile[lane * kStride + (x & (kRing - 1))] = out;\n",
         "                if (on) img[y * w + x] = out;\n"),
        ("        if (inside(xb, i)) img[(y0 + i) * w + xb] = tile[i * kStride + (xb & (kRing - 1))];\n",
         "")])
    spread = patch(package_src[:a] + package_src[package_src.index(STAGE_SPAN[1]):], [
        ("                // The step: lane r finishes pixel x = s - 2r.\n",
         "                {  // row kSub * q + t's stages at step t\n"
         "                    const int r = kSub * q + t, xb = col(c - 1, r), xp = col(c + 2, r);\n"
         "                    const uint32_t v = tile[r * kStride + (xb & (kRing - 1))];\n"
         "                    if (c > 0 && inside(xb, r)) img[(y0 + r) * w + xb] = v;\n"
         "                    if (inside(xp, r))\n"
         "                        cp_async4(&tile[r * kStride + (xp & (kRing - 1))], &img[(y0 + r) * w + xp]);\n"
         "                }\n"
         "                // The step: lane r finishes pixel x = s - 2r.\n")])
    no_fetch = patch(package_src, [("            fetch_rows(c + 2, kSub * q);\n", "")])
    out = {"rows": (package_src, True), "switch": (switch, True), "scalar": (scalar, True),
           "fields": (fields, True), "direct_store": (direct, True), "spread": (spread, True),
           "unrolled": (patch(package_src, [("#pragma unroll 1\n        for (int q = 0;",
                                             "#pragma unroll\n        for (int q = 0;")]), True),
           **{f"lag{n}": (patch(package_src, [("constexpr int kLag = 8;",
                                               f"constexpr int kLag = {n};")]), True)
              for n in (10, 12)},
           "sleep100": (package_src.replace("__nanosleep(20)", "__nanosleep(100)"), True),
           "no_fence": (no_fence, False), "no_stage": (no_stage, False),
           "no_fetch": (no_fetch, False),
           "no_predict": (patch(package_src, [(PREDICT_CALL, "T")]), False)}
    if probe:
        out["rows_probe"] = (patch(package_src, ROWS_PATCHES) + PROBE_API + STAMPS_API, True)
    if old_src is not None:
        out["one_block"] = (old_src, True)
        if probe:
            out["one_block_probe"] = (patch(old_src, OLD_PATCHES) + PROBE_API, True)
    return out


def build(work: Path, srcs: dict, common: Path, nvcc: str) -> dict:
    """Compile every version at once; name -> (library, ptxas lines of K12)."""
    procs = {}
    for name, (text, _) in srcs.items():
        d = work / name
        d.mkdir(parents=True)
        shutil.copy(common, d / "common.cuh")
        (d / "vp8l.cu").write_text(text)
        procs[name] = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(d / "lib.so"),
                                        str(d / "vp8l.cu")],
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {name} failed:\n{err}")
        lines, on = [], False
        for line in err.splitlines():
            if "Compiling entry function" in line:
                on = "predictor" in line
            elif on and ("registers" in line or "spill" in line):
                lines.append(line.split(":", 1)[-1].strip())
        sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(work / name / "lib.so")],
                              capture_output=True, text=True).stdout
        (work / name / "sass.txt").write_text(sass)
        body, on = 0, False
        for line in sass.splitlines():
            if "Function :" in line:
                on = "predictor" in line
            elif on and line.strip().startswith("/*") and "*/" in line and ";" in line:
                body += 1
        lines.append(f"{body} SASS instructions in K12's kernel")
        lib = ctypes.CDLL(str(work / name / "lib.so"))
        out[name] = (lib, lines)
    return out


def k12_inputs(dev):
    """name -> (residuals [8, h, w, 4], modes [8, bh, bw], size_bits) on `dev`,
    K12's own inputs on the main path's two lossless streams."""
    import numpy as np
    import torch

    import chip_smoke
    from webp_tpu_torch.decode import vp8l_device as ldev
    from webp_tpu_torch.ops import vp8l_device as K

    plain = {1: K.color_transform_plain_, 2: K.subtract_green_plain_}
    _, streams = chip_smoke.lossless_inputs(chip_smoke.WIDTH, chip_smoke.HEIGHT)
    out = {}
    for name, stream in zip(("photo", "packed"), streams):
        results = ldev.entropy_batch([stream], chip_smoke.WIDTH, chip_smoke.HEIGHT)
        sig = ldev.signature(results[0][1], results[0][0].shape[1])
        params = ldev.stack_params(results, [0], sig, chip_smoke.HEIGHT)
        px = torch.from_numpy(results[0][0][None].copy())
        for (ttype, size_bits, _), param in zip(reversed(sig[:-1]), reversed(params)):
            if ttype == 0:
                tile = (chip_smoke.BATCH, 1, 1, 1)
                out[name] = (px.repeat(*tile).to(dev),
                             torch.from_numpy(np.repeat(param, chip_smoke.BATCH, 0)).to(dev),
                             size_bits)
                break
            args = (torch.from_numpy(param),) if ttype == 1 else ()
            px = plain[ttype](px, *args, size_bits) if ttype == 1 else plain[ttype](px)
    return out


PROBE_API = """
WEBP_API int webp_k12_probe(void* host, int n) {
    return static_cast<int>(cudaMemcpyFromSymbol(host, k12_probe, n * sizeof(long long)));
}
"""
STAMPS_API = """
WEBP_API int webp_k12_stamps(void* host, int n) {
    return static_cast<int>(cudaMemcpyFromSymbol(host, k12_stamps, n * sizeof(long long)));
}
WEBP_API int webp_k12_subs(void* host, int n) {
    return static_cast<int>(cudaMemcpyFromSymbol(host, k12_subs, n * sizeof(long long)));
}
"""


def read_probe(lib, n_acc: int, shape, rows: bool) -> dict:
    """Mean cycles of each phase: per chunk and per step over the bands
    (`rows`), or per wavefront step over the images."""
    B, h = shape[:2]
    n = B * lib.webp_vp8l_predictor_bands(h) * K_WARPS if rows else B
    buf = (ctypes.c_longlong * (n * n_acc))()
    lib.webp_k12_probe.argtypes = [ctypes.c_void_p, ctypes.c_int]
    if lib.webp_k12_probe(buf, n * n_acc) != 0:
        raise RuntimeError("webp_k12_probe failed")
    recs = [buf[i * n_acc:(i + 1) * n_acc] for i in range(n)]
    if rows:  # the steps' acc holds the waits inside them
        bands = [r for r in recs[:n // B] if r[7] > 0]  # image 0's bands, top down
        recs = [r for r in recs if r[7] > 0]  # bands below the image never ran
        for r in recs:
            r[2] -= r[1]
        out = {ph: round(statistics.mean(r[k] / r[7] for r in recs), 1)
               for k, ph in enumerate(ROWS_PHASES)}
        out["cycles_per_step"] = round(statistics.mean(r[2] / r[7] / 32 for r in recs), 1)
        # Image 0: each band's start after its first wait and its end, in us
        # from the top band's start, and the mean gap between the starts of
        # two bands in a row.
        t0 = bands[0][4]
        starts = [round((r[6] - t0) / 1e3, 2) for r in bands]
        out["band_start_us"] = starts
        out["band_end_us"] = [round((r[5] - t0) / 1e3, 2) for r in bands]
        out["start_gap_us"] = round((starts[-1] - starts[0]) / max(1, len(starts) - 1), 3)
        # Each band's chunk starts, as us per chunk from one to the next.
        stamps = (ctypes.c_longlong * (len(bands) * 64))()
        lib.webp_k12_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        if lib.webp_k12_stamps(stamps, len(bands) * 64) != 0:
            raise RuntimeError("webp_k12_stamps failed")
        out["chunk_us"] = [[round((stamps[i * 64 + c + 1] - stamps[i * 64 + c]) / 1e3, 2)
                            for c in range(int(r[7]) - 1)] for i, r in enumerate(bands)]
        # Bands below the top: each of the first 8 sub-chunks' end of wait, in
        # us from the top band's start, and the polls it slept.
        subs = (ctypes.c_longlong * (len(bands) * 16))()
        lib.webp_k12_subs.argtypes = [ctypes.c_void_p, ctypes.c_int]
        if lib.webp_k12_subs(subs, len(bands) * 16) != 0:
            raise RuntimeError("webp_k12_subs failed")
        out["sub_waits"] = [[(round((subs[(i * 8 + q) * 2] - t0) / 1e3, 2), subs[(i * 8 + q) * 2 + 1])
                             for q in range(8)] for i in range(1, len(bands))]
        return out
    return {ph: round(statistics.mean(r[k] / r[3] for r in recs), 1)
            for k, ph in enumerate(OLD_PHASES)}


K_WARPS = 4  # bands a CTA of the probed kernel


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, help="a csrc/ holding the one-block-per-image vp8l.cu")
    ap.add_argument("--probe", action="store_true", help="clock64() probes per phase")
    ap.add_argument("--only", help="comma-separated versions to build and run (default: all)")
    ap.add_argument("--out", type=Path, help="also write the numbers to this JSON file")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("vp8l_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    from webp_tpu_torch import _build
    from webp_tpu_torch.ops import vp8l_device as K

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    work = ROOT / "build" / "vp8l_split"
    shutil.rmtree(work, ignore_errors=True)
    old = (args.csrc / "vp8l.cu").read_text() if args.csrc else None
    srcs = versions((_build.CSRC / "vp8l.cu").read_text(), old, args.probe)
    if args.only:
        srcs = {k: v for k, v in srcs.items() if k in args.only.split(",")}
    libs = build(work, srcs, _build.CSRC / "common.cuh", _build._nvcc())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    P, I = ctypes.c_void_p, ctypes.c_int

    def launcher(lib):
        fn = lib.webp_vp8l_predictor
        rows = hasattr(lib, "webp_vp8l_predictor_bands")
        fn.argtypes = [P, P, I, I, I, I] + ([P, P] if rows else []) + [P]
        fn.restype = I

        def run(px, modes, size_bits, scratch):
            B, h, w = px.shape[:3]
            extra = [scratch[0].data_ptr(), scratch[1].data_ptr()] if rows else []
            rc = fn(px.data_ptr(), modes.data_ptr(), size_bits, w, h, B, *extra,
                    torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"K12 launch failed: CUDA error {rc}")
        run.lib = lib
        return run

    def scratch_for(px, lib):
        B, h, w = px.shape[:3]
        nb = lib.webp_vp8l_predictor_bands(h) if hasattr(lib, "webp_vp8l_predictor_bands") else 1
        return (torch.empty(B * nb * w, dtype=torch.int32, device=dev),
                torch.zeros(B * nb + 1, dtype=torch.int32, device=dev))

    def time_ms(run, src, modes, size_bits, reps=10):
        work_px, scratch = src.clone(), scratch_for(src, run.lib)
        times = []
        for _ in range(reps + 1):
            work_px.copy_(src)
            scratch[1].zero_()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            run(work_px, modes, size_bits, scratch)
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times[1:]), work_px

    inputs = k12_inputs(dev)
    want = {name: K.inverse_predictor_plain_(px[:1].cpu().clone(), modes[:1].cpu(), sb)
            for name, (px, modes, sb) in inputs.items()}
    rng = np.random.RandomState(21)
    bands = {}
    for w in STEP_WIDTHS:
        bands[w] = (torch.from_numpy(rng.randint(0, 256, (1, 32, w, 4)).astype(np.uint8)).to(dev),
                    torch.from_numpy(rng.randint(0, 14, (1, 8, w // 4)).astype(np.uint8)).to(dev))
    out = {"card": card, "csrc": str(args.csrc) if args.csrc else None, "versions": {}}
    for name, (lib, ptxas) in libs.items():
        run = launcher(lib)
        rec = {"ptxas": ptxas}
        for inp, (px, modes, sb) in inputs.items():
            for n in (8, 1):
                ms, got = time_ms(run, px[:n].contiguous(), modes[:n].contiguous(), sb)
                rec[f"{inp}_b{n}_ms"] = ms
                same = all(torch.equal(got[i].cpu(), want[inp][0]) for i in range(n))
                rec[f"{inp}_b{n}_exact"] = same
                if srcs[name][1] and not same:
                    raise AssertionError(f"{name} differs from the plain twin on {inp}, batch {n}")
        t = [time_ms(run, *bands[w], 2)[0] for w in STEP_WIDTHS]
        rec["step_us"] = (t[1] - t[0]) / (STEP_WIDTHS[1] - STEP_WIDTHS[0]) * 1e3
        if name.endswith("_probe"):
            n_acc = 8 if name == "rows_probe" else 4
            px, modes, sb = inputs["photo"]
            time_ms(run, px, modes, sb, reps=1)
            rec["probe"] = read_probe(lib, n_acc, px.shape, name == "rows_probe")
        out["versions"][name] = rec
        print(f"{name}: " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                                      for k, v in rec.items() if k != "probe")
              + f" ({card})", flush=True)
        if "probe" in rec:
            print(f"{name} probe: {rec['probe']}", flush=True)
    print(smi)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

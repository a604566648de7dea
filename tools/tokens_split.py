#!/usr/bin/env python3
"""Time kernel K13, the coefficient-partition token coder
(`webp_tpu_torch/csrc/tokens.cu`), in its versions, with K14 and K15 on the
same coder step, and where an op's time goes, on one NVIDIA GPU.

    python3 tools/tokens_split.py [--csrc DIR] [--probe] [--only NAMES] [--out FILE]

Inputs are `chip_smoke.py`'s flagship encode (two seeded 768x512 frames
tiled to 8, Q75 method 4, segments on): its pass-2 arrays and adapted
probabilities, made on the card by the package's kernels, tiled to batch
64 and cut to batch 1; K14 continues the images' frame headers with their
MB headers; K15 codes the adversarial carry streams of
`tests/token_inputs.py`.  The script copies `tokens.cu` and its headers of
each version into `build/tokens_split/<name>/` and builds them all at once
with nvcc (`-Xptxas -v`), one shared library each, loaded with ctypes:

- `ring`: the package's kernels (three producer warps and a coder warp a
  K13 lane);
- `p2`, `p4`: K13 with two or four producer warps;
- `branch_store`: the coder step's byte store and carry mark behind a
  branch on the emitted byte instead of two predicated instructions;
- `lane0_store`: only lane 0 of the coder warp stores (a predicated
  store: no divergence);
- `sleepy`: the producers poll their counters every 0.5–1 µs, not every
  32–64 ns;
- `ring4k`: K13 with a ring of 4096 ops (8 KB) instead of 8192;
- `no_store` (a diagnostic, not exact): the coder steps store no byte
  and mark no carry, to show what the stores cost;
- `one_thread`, with --csrc DIR: DIR's `tokens.cu` and headers (the
  one-thread-per-lane kernels of commit dd88190: `git archive dd88190
  webp_tpu_torch/csrc | tar -x -C build/tokens_parent` gives DIR =
  build/tokens_parent/webp_tpu_torch/csrc).

Each version runs K13 at batch 64, 8 and 1, K14 at batch 8 and K15 (CUDA
events, the median of ten launches), each checked against the plain twin
of its inputs (the exact versions must equal it).  For the package's
versions the coder step is timed alone (`webp_coder_chain`: one warp, two
chain lengths of ops in shared memory), with the chain floor of each
batch (its longest lane's ops times the step) and the CTAs the card keeps
resident.  It prints ptxas's registers, shared memory and spills of each
version's kernels, with the card's name and power limit.

--probe adds `clock64()` probes (text patches at anchors of the sources;
the script stops at an anchor not found exactly once), at batch 8: in
`ring`, per lane, the coder warp's cycles coding and waiting on the ring
(and its ops), and per producer warp and MB the cycles of the levels'
loads with the skip vote, the contexts with the op count, the scan with
the wait for the MB's start, and the ring writes with their waits for
space and the publish; in `one_thread` (with --csrc), per lane and MB, the
skip scan, the 25 blocks' contexts, and the coding of their ops.
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
HEADERS = ("boolenc.cuh", "common.cuh", "contexts.cuh")
BATCHES = (64, 8, 1)
N_PROBE = 16  # long longs a K13 lane (CTA) of probes

PROBE_DECL = """
__device__ long long k13_probe[1 << 16];
__device__ __forceinline__ long long now() { return clock64(); }
"""
PROBE_API = """
WEBP_API int webp_k13_probe(void* host, int n) {
    return static_cast<int>(cudaMemcpyFromSymbol(host, k13_probe, n * sizeof(long long)));
}
WEBP_API int webp_k13_probe_clear() {
    static long long zeros[1 << 16];
    return static_cast<int>(cudaMemcpyToSymbol(k13_probe, zeros, sizeof(zeros)));
}
"""
# The package's K13, per lane: [0] the coder warp's cycles coding, [1]
# waiting, [2] its ops; summed over the producer warps' lane 0, [4] the
# loads with the skip vote, [5] contexts and op count, [6] the scan and
# the wait for the MB's start, [7] the ring writes with their waits and
# the publish, [8] the MBs.
RING_PATCHES = [
    ("namespace {\n", PROBE_DECL + "namespace {\n"),
    ("__device__ void consume(TokShared& S, LaneCoder& c, int n_mb) {\n    int pos = 0;\n",
     "__device__ void consume(TokShared& S, LaneCoder& c, int n_mb) {\n    int pos = 0;\n"
     "    long long t_all = now(), t_code = 0;\n"),
    ("        pos = code_span(c, S.ring, pos, lim, &S.consumed);\n",
     "        const long long t0 = now();\n"
     "        pos = code_span(c, S.ring, pos, lim, &S.consumed);\n"
     "        t_code += now() - t0;\n"),
    ("        publish(&S.consumed, pos);\n    }\n}\n",
     "        publish(&S.consumed, pos);\n    }\n"
     "    if (threadIdx.x % kWarp == 0) {\n"
     "        long long* acc = k13_probe + blockIdx.x * 16;\n"
     "        acc[0] = t_code;\n        acc[1] = now() - t_all - t_code;\n        acc[2] = pos;\n"
     "    }\n}\n"),
    ("        const bool has_y2 = L.lmode[m] != 4;\n        const int first = is_y && has_y2",
     "        const long long q0 = now();\n"
     "        const bool has_y2 = L.lmode[m] != 4;\n        const int first = is_y && has_y2"),
    ("        int count = 0, ctx = 0;\n        if (__any_sync(kFull, end > 0)) {",
     "        int count = 0, ctx = 0;\n        const bool coded_mb = __any_sync(kFull, end > 0);\n"
     "        const long long q1 = now();\n        if (coded_mb) {"),
    ("        int incl = count;  // inclusive scan of the blocks' op counts\n",
     "        const long long q2 = now();\n"
     "        int incl = count;  // inclusive scan of the blocks' op counts\n"),
    ("        const int base = start + incl - count;\n",
     "        const int base = start + incl - count;\n        const long long q3 = now();\n"),
    ("            __syncwarp();\n        }\n    }\n}\n",
     "            __syncwarp();\n        }\n"
     "        if (lane == 0) {\n"
     "            long long* acc = k13_probe + blockIdx.x * 16;\n"
     "            atomicAdd(reinterpret_cast<unsigned long long*>(acc + 4), q1 - q0);\n"
     "            atomicAdd(reinterpret_cast<unsigned long long*>(acc + 5), q2 - q1);\n"
     "            atomicAdd(reinterpret_cast<unsigned long long*>(acc + 6), q3 - q2);\n"
     "            atomicAdd(reinterpret_cast<unsigned long long*>(acc + 7), now() - q3);\n"
     "            atomicAdd(reinterpret_cast<unsigned long long*>(acc + 8), 1ull);\n"
     "        }\n    }\n}\n"),
]
RING_PHASES = {"coding": 0, "coder_wait": 1, "loads_skip": 4, "contexts_count": 5,
               "scan_start": 6, "ring_writes": 7}
# The one-thread kernel (commit dd88190): per lane, [0] skip scans, [1]
# contexts, [2] coding (block loads, table loads, coder steps), [3] MBs coded.
OLD_PATCHES = [
    ("namespace {\n", PROBE_DECL + "namespace {\n"),
    ("            if (all_zero(L.y2 + m * 16, 16) && all_zero(L.y + m * 256, 256)\n"
     "                && all_zero(L.uv + m * 128, 128)) {\n",
     "            long long* acc = k13_probe + blockIdx.x * 16;\n"
     "            const long long t0 = now();\n"
     "            const bool skip_ = all_zero(L.y2 + m * 16, 16) && all_zero(L.y + m * 256, 256)\n"
     "                && all_zero(L.uv + m * 128, 128);\n"
     "            const long long t1 = now();\n            acc[0] += t1 - t0;\n"
     "            if (skip_) {\n"),
    ("            const bool has_y2 = L.lmode[m] != 4;\n            if (has_y2) {\n"
     "                code_block(c, tab, sp + 1 * 264, L.y2 + m * 16, 0, y2_ctx(L, m, mx, my, mbw));\n",
     "            const bool has_y2 = L.lmode[m] != 4;\n"
     "            int cx[25];\n            cx[0] = has_y2 ? y2_ctx(L, m, mx, my, mbw) : 0;\n"
     "            for (int s = 0; s < 16; ++s) cx[1 + s] = y_ctx(L, m, s, mx, my, mbw);\n"
     "            for (int s = 0; s < 8; ++s) cx[17 + s] = uv_ctx(L, m, s, mx, my, mbw);\n"
     "            const long long t2 = now();\n            acc[1] += t2 - t1;\n"
     "            if (has_y2) {\n"
     "                code_block(c, tab, sp + 1 * 264, L.y2 + m * 16, 0, cx[0]);\n"),
    ("                           y_ctx(L, m, s, mx, my, mbw));\n", "                           cx[1 + s]);\n"),
    ("                           uv_ctx(L, m, s, mx, my, mbw));\n            }\n",
     "                           cx[17 + s]);\n            }\n"
     "            acc[2] += now() - t2;\n            acc[3] += 1;\n"),
]
OLD_PHASES = {"skip_scan": 0, "contexts": 1, "coding": 2}


def patch(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"anchor found {src.count(old)} times: {old[:70]!r}")
        src = src.replace(old, new)
    return src


STORES = """        store_byte_if(out + n, t >> 24, emit && n < cap);
        // The bit that leaves bottom's top as the byte does: a carry (rare).
        or_word_if(carries + (n >> 5), 1u << (n & 31),
                   emit && __funnelshift_l(b2, 0u, j) != 0 && n <= cap);
"""
BRANCH_STORES = """        if (emit) {
            if (n < cap) out[n] = static_cast<uint8_t>(t >> 24);
            if ((b2 >> (32 - j)) != 0 && n <= cap) atomicOr(carries + (n >> 5), 1u << (n & 31));
        }
"""


def knob(src: str, name: str, old: int, new: int) -> str:
    return patch(src, [(f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")])


def versions(csrc: Path, old: Path | None, probe: bool) -> dict:
    """name -> (source dir, tokens.cu text, exact, new entry points, header
    texts that replace the source dir's)."""
    src = (csrc / "tokens.cu").read_text()
    coder = (csrc / "boolenc.cuh").read_text()
    out = {
        "ring": (csrc, src, True, True, {}),
        "branch_store": (csrc, src, True, True, {"boolenc.cuh": patch(coder, [(STORES,
                                                                               BRANCH_STORES)])}),
        "p2": (csrc, knob(src, "kProducers", 3, 2), True, True, {}),
        "p4": (csrc, knob(src, "kProducers", 3, 4), True, True, {}),
        "ring4k": (csrc, knob(src, "kRing", 8192, 4096), True, True, {}),
        "no_store": (csrc, src, False, True, {"boolenc.cuh": patch(coder, [(STORES, "")])}),
        "lane0_store": (csrc, src, True, True, {"boolenc.cuh": patch(coder, [(
            "t >> 24, emit && n < cap);", "t >> 24, emit && n < cap && (threadIdx.x & 31) == 0);")])}),
        "sleepy": (csrc, src.replace("__nanosleep(64)", "__nanosleep(1000)").replace(
            "__nanosleep(32)", "__nanosleep(500)"), True, True, {}),
    }
    if probe:
        out["ring_probe"] = (csrc, patch(src, RING_PATCHES) + PROBE_API, True, True, {})
    if old is not None:
        old_src = (old / "tokens.cu").read_text()
        out["one_thread"] = (old, old_src, True, False, {})
        if probe:
            out["one_thread_probe"] = (old, patch(old_src, OLD_PATCHES) + PROBE_API, True, False,
                                       {})
    return out


def build(work: Path, srcs: dict, nvcc: str) -> dict:
    """Compile every version at once; name -> (library, ptxas lines)."""
    procs = {}
    for name, (hdr_dir, text, _, _, headers) in srcs.items():
        d = work / name
        d.mkdir(parents=True)
        for h in HEADERS:
            shutil.copy(hdr_dir / h, d / h)
        for h, h_text in headers.items():
            (d / h).write_text(h_text)
        (d / "tokens.cu").write_text(text)
        procs[name] = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(d / "lib.so"),
                                        str(d / "tokens.cu")],
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {name} failed:\n{err}")
        lines, kernel = [], None
        for line in err.splitlines():
            if "Compiling entry function" in line:
                kernel = next((k for k in ("coeff_tokens", "mb_headers", "bool_lanes",
                                           "coder_chain") if k in line), None)
            elif kernel and ("registers" in line or "spill" in line):
                lines.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
        out[name] = (ctypes.CDLL(str(work / name / "lib.so")), lines)
    return out


def flagship_inputs(dev):
    """(K13's inputs at batch 8, K14's inputs and parameters, mbw, mbh):
    chip_smoke's flagship pass 2 on the card."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from webp_tpu_torch.common import vp8_tables as T
    from webp_tpu_torch.encode import device as edev
    from webp_tpu_torch.ops import token_ops
    from webp_tpu_torch.ops.enc_params import EncTables
    from webp_tpu_torch.ops.encode_wavefront import encode_analysis_batch

    method, segments = cs.ENCODES[-1]
    _, rgbs = cs.encode_inputs(cs.WIDTH, cs.HEIGHT)
    n_try = edev.n_try_for(method)
    y, u, v = edev.upload(edev.rgb_to_planes(rgbs), dev)
    segs = edev.segment(y, u, v, cs.QUALITY) if segments else None
    P, sid = edev.params_for(segs, cs.QUALITY, dev)
    default = EncTables.from_probs(T.COEFF_PROBS_DEFAULT, dev)
    totals, ones = edev.encode_analysis_stats_batch(y, u, v, P, default, min(n_try, 3), sid)
    probs = edev.adapt_probs(totals.cpu().numpy(), ones.cpu().numpy())
    pass2 = encode_analysis_batch(y, u, v, P, edev.tables_for(probs, dev), n_try, method >= 4,
                                  sid)
    mbw, mbh = cs.WIDTH // 16, cs.HEIGHT // 16
    skipped = edev.skip_flags(pass2)
    pf = torch.from_numpy(np.ascontiguousarray(probs, np.uint8).reshape(cs.BATCH, -1)).to(dev)
    tok_in = [pass2["luma_mode"], pass2["y2_levels"], pass2["y_levels"], pass2["uv_levels"], pf]
    lanes = token_ops.encode_coeff_partitions(*tok_in, mbw, mbh, cs.PARTITIONS)
    tokens = edev.fetch_tokens(pass2, skipped, lanes, sid)
    coders = edev.header_coders(tokens, probs, cs.QUALITY, segs)
    params = edev.mb_header_params(tokens, coders, segs)
    hdr_in = [pass2["luma_mode"], pass2["bpred"], pass2["chroma_mode"],
              torch.zeros_like(pass2["luma_mode"]) if sid is None else sid, skipped, params]
    return tok_in, hdr_in, mbw, mbh


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, help="a csrc/ holding the one-thread tokens.cu")
    ap.add_argument("--probe", action="store_true", help="clock64() probes per phase")
    ap.add_argument("--only", help="comma-separated versions to build and run (default: all)")
    ap.add_argument("--out", type=Path, help="also write the numbers to this JSON file")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("tokens_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import chip_smoke as cs
    from token_inputs import CARRY_PATTERNS
    from webp_tpu_torch import _build
    from webp_tpu_torch.ops import boolenc2, token_ops

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    work = ROOT / "build" / "tokens_split"
    shutil.rmtree(work, ignore_errors=True)
    srcs = versions(_build.CSRC, args.csrc, args.probe)
    if args.only:
        srcs = {k: v for k, v in srcs.items() if k in args.only.split(",")}
    libs = build(work, srcs, _build._nvcc())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    Pt, I, Lg = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    tok8, hdr_in, mbw, mbh = flagship_inputs(dev)
    nparts, nmb = cs.PARTITIONS, mbw * mbh
    tok = {n: [a.repeat(n // cs.BATCH, *([1] * (a.dim() - 1))) if n > cs.BATCH
               else a[:n].contiguous() for a in tok8] for n in BATCHES}
    hdr_in = [a.contiguous() for a in hdr_in]
    want8 = token_ops.encode_coeff_partitions_plain(*(a.cpu() for a in tok8), mbw, mbh, nparts,
                                                    token_ops.token_budget(nmb, nparts))
    cap = int(want8.n_bytes.max())
    want8 = want8._replace(data=want8.data[..., :cap])
    hdr_want = token_ops.encode_mb_headers(*(a.cpu() for a in hdr_in), mbw, mbh)
    hcap = hdr_want.data.shape[-1]
    steps, n_lanes = max(len(b) for b, _ in CARRY_PATTERNS), len(CARRY_PATTERNS)
    streams = np.zeros((3, steps, n_lanes), np.uint8)
    for lane, (b, p) in enumerate(CARRY_PATTERNS):
        streams[0, :len(b), lane], streams[1, :len(b), lane], streams[2, :len(b), lane] = b, p, 1
    k15_in = [torch.from_numpy(a).to(dev) for a in streams]
    k15_want = boolenc2.bool_encode_lanes_plain(*(a.cpu() for a in k15_in), 4096)
    k15_state = torch.tensor([boolenc2.INIT_STATE] * n_lanes, dtype=torch.int64, device=dev)

    def time_ms(fn, reps=10):
        times = []
        for _ in range(reps + 1):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times[1:])

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} launch failed: CUDA error {rc}")

    out = {"card": card, "csrc": str(args.csrc) if args.csrc else None, "versions": {}}
    for name, (lib, ptxas) in libs.items():
        exact, new = srcs[name][2], srcs[name][3]
        scratch = [Pt] if new else []
        lib.webp_coeff_tokens.argtypes = ([Pt, Lg, Pt, Pt, Pt, Pt, Pt, I, I, I, I, I, I, Pt]
                                          + scratch + [Pt, Pt])
        lib.webp_mb_headers.argtypes = ([Pt, Lg, Pt, Lg, Pt, Lg, Pt, Lg, Pt, Lg, Pt, Pt, I, I, I,
                                         I, I, Pt] + scratch + [Pt, Pt])
        lib.webp_bool_lanes.argtypes = [Pt, Pt, Pt, I, I, Pt, I, Pt] + scratch + [Pt, Pt]
        consts = _build.device_constant("token_consts", token_ops.TOKEN_CONSTS_NP, dev)
        hconsts = _build.device_constant("header_consts", token_ops.HEADER_CONSTS_NP, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rec = {"ptxas": ptxas}

        def k13(n, lib=lib, scratch=scratch):
            lm, y2, y, uv, pf = tok[n]
            info = torch.empty((n, nparts, 6), dtype=torch.int64, device=dev)
            data = torch.zeros((n, nparts, cap), dtype=torch.uint8, device=dev)
            marks = torch.empty((n, nparts, boolenc2.carry_words(cap)), dtype=torch.int32,
                                device=dev)
            extra = [marks.data_ptr()] if scratch else []
            check(lib.webp_coeff_tokens(lm.data_ptr(), nmb, y2.data_ptr(), y.data_ptr(),
                                        uv.data_ptr(), pf.data_ptr(), consts.data_ptr(),
                                        consts.numel(), mbw, mbh, n, nparts, cap, data.data_ptr(),
                                        *extra, info.data_ptr(), stream), "K13")
            return boolenc2.Lanes.from_fields(info, data)

        for n in BATCHES:
            got = k13(n)
            torch.cuda.synchronize()
            same = all(torch.equal(g.cpu(), w.repeat(max(1, n // cs.BATCH), *([1] * (w.dim() - 1)))
                                   [:n]) for g, w in zip(got, want8))
            rec[f"k13_b{n}_exact"] = same
            if exact and not same:
                raise AssertionError(f"{name}: K13 differs from the plain twin at batch {n}")
            rec[f"k13_b{n}_ms"] = time_ms(lambda n=n: k13(n))

        lm, bp, cm, sid, sk, params = hdr_in

        def k14(lib=lib, scratch=scratch):
            info = torch.empty((cs.BATCH, 6), dtype=torch.int64, device=dev)
            data = torch.zeros((cs.BATCH, hcap), dtype=torch.uint8, device=dev)
            marks = torch.empty((cs.BATCH, boolenc2.carry_words(hcap)), dtype=torch.int32,
                                device=dev)
            extra = [marks.data_ptr()] if scratch else []
            sk8 = sk.to(torch.uint8)
            check(lib.webp_mb_headers(lm.data_ptr(), nmb, bp.data_ptr(), nmb * 16, cm.data_ptr(),
                                      nmb, sid.data_ptr(), nmb, sk8.data_ptr(), nmb,
                                      params.data_ptr(), hconsts.data_ptr(), hconsts.numel(), mbw,
                                      mbh, cs.BATCH, hcap, data.data_ptr(), *extra,
                                      info.data_ptr(), stream), "K14")
            return boolenc2.Lanes.from_fields(info, data)

        def k15(lib=lib, scratch=scratch):
            info = torch.empty((n_lanes, 6), dtype=torch.int64, device=dev)
            data = torch.zeros((n_lanes, 4096), dtype=torch.uint8, device=dev)
            marks = torch.empty((n_lanes, boolenc2.carry_words(4096)), dtype=torch.int32,
                                device=dev)
            extra = [marks.data_ptr()] if scratch else []
            check(lib.webp_bool_lanes(*(a.data_ptr() for a in k15_in), steps, n_lanes,
                                      k15_state.data_ptr(), 4096, data.data_ptr(), *extra,
                                      info.data_ptr(), stream), "K15")
            return boolenc2.Lanes.from_fields(info, data)

        for kname, fn, want in (("k14", k14, hdr_want), ("k15", k15, k15_want)):
            got = fn()
            torch.cuda.synchronize()
            same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
            rec[f"{kname}_exact"] = same
            if exact and not same:
                raise AssertionError(f"{name}: {kname} differs from the plain twin")
            rec[f"{kname}_ms"] = time_ms(fn)

        longest = {n: int(want8.n_ops[:max(1, n // cs.BATCH) * cs.BATCH][:n].max())
                   for n in BATCHES}
        if new and hasattr(lib, "webp_coder_chain"):
            lib.webp_coder_chain.argtypes = [Pt, I, I, Pt, Pt, Pt, Pt]
            lib.webp_coeff_tokens_ring.restype = I
            lib.webp_coeff_tokens_resident.restype = I
            ring = lib.webp_coeff_tokens_ring()
            rng = np.random.RandomState(cs.CHAIN_SEED)
            ops = torch.from_numpy((rng.randint(1, 256, ring) | rng.randint(0, 2, ring) << 8)
                                   .astype(np.int16)).to(dev)
            ccap = cs.CHAIN_PASSES[-1] * ring
            cdata = torch.zeros(ccap, dtype=torch.uint8, device=dev)
            cmarks = torch.empty(boolenc2.carry_words(ccap), dtype=torch.int32, device=dev)
            cinfo = torch.empty(6, dtype=torch.int64, device=dev)
            t = [time_ms(lambda p=p: check(lib.webp_coder_chain(
                ops.data_ptr(), p, ccap, cdata.data_ptr(), cmarks.data_ptr(), cinfo.data_ptr(),
                stream), "chain")) for p in cs.CHAIN_PASSES]
            step_ns = (t[1] - t[0]) / ((cs.CHAIN_PASSES[1] - cs.CHAIN_PASSES[0]) * ring) * 1e6
            rec["step_ns"] = step_ns
            rec["resident_ctas"] = lib.webp_coeff_tokens_resident()
            for n in BATCHES:
                rec[f"chain_floor_b{n}_ms"] = longest[n] * step_ns / 1e6
        for n in BATCHES:
            rec[f"ns_per_op_b{n}"] = rec[f"k13_b{n}_ms"] * 1e6 / longest[n]
        if name.endswith("_probe"):
            lib.webp_k13_probe.argtypes = [Pt, I]
            n = cs.BATCH * nparts
            check(lib.webp_k13_probe_clear(), "probe clear")
            k13(cs.BATCH)
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * (n * N_PROBE))()
            check(lib.webp_k13_probe(buf, n * N_PROBE), "probe copy")
            recs = [buf[i * N_PROBE:(i + 1) * N_PROBE] for i in range(n)]
            lane = int(want8.n_ops.reshape(-1).argmax())  # the longest lane
            ops_l = int(want8.n_ops.reshape(-1)[lane])
            if name == "ring_probe":
                prb = {k: recs[lane][i] for k, i in RING_PHASES.items()}
                mbs = recs[lane][8]
                rec["probe"] = {"lane_ops": ops_l, "cycles_per_op": {
                    k: round(v / ops_l, 1) for k, v in prb.items() if k.startswith("cod")},
                    "producer_cycles_per_mb": {k: round(v / max(1, mbs), 1) for k, v in prb.items()
                                               if not k.startswith("cod")}}
            else:
                prb = {k: recs[lane][i] for k, i in OLD_PHASES.items()}
                mbs = recs[lane][3]
                rec["probe"] = {"lane_ops": ops_l, "mbs_coded": mbs,
                                "cycles_per_op": {k: round(v / ops_l, 1) for k, v in prb.items()}}
        out["versions"][name] = rec
        print(f"{name}: " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                                      for k, v in rec.items() if k not in ("probe", "ptxas"))
              + f" ({card})", flush=True)
        print(f"{name} ptxas: {ptxas}", flush=True)
        if "probe" in rec:
            print(f"{name} probe: {rec['probe']}", flush=True)
    print(smi)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

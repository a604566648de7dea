#!/usr/bin/env python3
"""Time the device token coder's kernels (`webp_tpu_torch/csrc/tokens.cu`):
K14, the MB-header coder, beside the parent's, with K13 and K15 in the same
call, and where an op's time goes, on one NVIDIA GPU.

    python3 tools/tokens_split.py [--csrc DIR] [--probe] [--only NAMES] [--out FILE]

Inputs are `chip_smoke.py`'s flagship encode (two seeded 768x512 frames
tiled to 8, Q75 method 4, segments on): its pass-2 arrays and adapted
probabilities, made on the card by the package's kernels, tiled to batch
64 and cut to batch 1.  K14 continues the images' frame headers with their
MB headers (the segment map written); K13 codes the coefficient
partitions; K15 codes the adversarial carry streams of
`tests/token_inputs.py`.  The script copies `tokens.cu` and its headers of
each version into `build/tokens_split/<name>/` and builds them all at once
with nvcc (`-Xptxas -v`), one shared library each, loaded with ctypes:

- `package`: the package's kernels (K14: a CTA an image counts, scans and
  writes the header ops, then one warp codes them);
- `parent`, with --csrc DIR: DIR's `tokens.cu` and headers (the parent
  commit's, whose K14 generates each op on the coding thread: `git archive
  1cb3b2e webp_tpu_torch/csrc | tar -x -C build/tokens_parent` gives DIR =
  build/tokens_parent/webp_tpu_torch/csrc).

Each version runs K13 and K14 at batch 64, 8 and 1 and K15 (CUDA events,
the median of ten launches), each checked against the plain twin of its
inputs.  The coder step is timed alone on the package (`webp_coder_chain`:
one warp, two chain lengths of ops in shared memory), with each kernel's
chain floor at each batch (its longest lane's ops times the step) and
K13's resident CTAs.  It prints ptxas's registers, shared memory and spills
of each version's kernels, with the card's name and power limit.

--probe adds `package_probe`, the package with `clock64()` probes (text
patches at anchors of the sources; the script stops at an anchor not found
exactly once), at batch 8: in K14, per image, the cycles of the count and
write phases (from the CTA's start to the barrier before the coder), the
coder warp's cycles, the part of them it waits on its op loads (from
before the vector it is about to code is used to after), and its ops; in
K13, per lane, the coder warp's cycles coding and waiting on the ring (and
its ops), and per producer warp and MB the cycles of the levels' loads
with the skip vote, the contexts with the op count, the scan with the wait
for the MB's start, and the ring writes with their waits for space and the
publish.
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

K14_PROBE = 1 << 15  # K14's probes start here, N_PROBE a CTA (image)
PROBE_DECL = """
__device__ long long k13_probe[1 << 16];
__device__ __forceinline__ long long now() { return clock64(); }
// The clock once x is computed (an instruction that uses x waits for it).
__device__ __forceinline__ long long now_after(uint32_t x) {
    uint32_t y;
    asm volatile("mov.b32 %0, %1;" : "=r"(y) : "r"(x));
    long long t;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : "r"(y) : "memory");
    return t;
}
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
# The package's K14, per image at K14_PROBE + b * N_PROBE: [0] the cycles
# from the CTA's start to the barrier before the coder (tables, count, scan
# and write), [1] the coder warp's cycles, [2] the part it waited on its op
# loads, [3] its ops.
K14_PATCHES = [
    ("    const int b = blockIdx.x, tid = threadIdx.x;\n",
     "    const long long t_entry = now();\n    const int b = blockIdx.x, tid = threadIdx.x;\n"),
    ("    __syncthreads();  // the stream, written by every thread, is read by warp 0\n",
     "    __syncthreads();  // the stream, written by every thread, is read by warp 0\n"
     "    if (tid == 0) k13_probe[(1 << 15) + b * 16] = now() - t_entry;\n"),
    ("    uint4 a = v[0], b = v[min(1, last_vec)], d = v[min(2, last_vec)];\n",
     "    const long long t_all = now();\n    long long waited = 0;\n"
     "    uint4 a = v[0], b = v[min(1, last_vec)], d = v[min(2, last_vec)];\n"),
    ("        const uint4 e = v[min(i + 3, last_vec)];\n        c.put8(a);\n",
     "        const uint4 e = v[min(i + 3, last_vec)];\n"
     "        const long long w0 = now();\n"
     "        waited += now_after(a.x ^ a.y ^ a.z ^ a.w ^ static_cast<uint32_t>(w0 >> 62)) - w0;\n"
     "        c.put8(a);\n"),
    ("    for (int k = nvec * 8; k < n; ++k) c.put_op(ops[k]);\n}\n",
     "    for (int k = nvec * 8; k < n; ++k) c.put_op(ops[k]);\n"
     "    if (threadIdx.x == 0) {\n"
     "        long long* acc = k13_probe + (1 << 15) + blockIdx.x * 16;\n"
     "        acc[1] = now() - t_all;\n        acc[2] = waited;\n        acc[3] = n;\n"
     "    }\n}\n"),
]
K14_PHASES = {"count_write": 0, "coder": 1, "coder_wait": 2}


def patch(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"anchor found {src.count(old)} times: {old[:70]!r}")
        src = src.replace(old, new)
    return src


def versions(csrc: Path, parent: Path | None, probe: bool) -> dict:
    """name -> (source dir, tokens.cu text, whether K14 takes the op-stream
    scratch)."""
    src = (csrc / "tokens.cu").read_text()
    out = {"package": (csrc, src, True)}
    if probe:
        out["package_probe"] = (csrc, patch(src, RING_PATCHES + K14_PATCHES) + PROBE_API, True)
    if parent is not None:
        out["parent"] = (parent, (parent / "tokens.cu").read_text(), False)
    return out


def build(work: Path, srcs: dict, nvcc: str) -> dict:
    """Compile every version at once; name -> (library, ptxas lines)."""
    procs = {}
    for name, (hdr_dir, text, _) in srcs.items():
        d = work / name
        d.mkdir(parents=True)
        for h in HEADERS:
            shutil.copy(hdr_dir / h, d / h)
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
            elif kernel and ("registers" in line or "spill" in line or "smem" in line):
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


def tile(arrays, n: int, batch: int):
    """Batch-8 arrays tiled to batch n (> 8) or cut to it, contiguous."""
    return [a.repeat(n // batch, *([1] * (a.dim() - 1))) if n > batch else a[:n].contiguous()
            for a in arrays]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, help="the parent's csrc/, whose K14 to time beside")
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

    tok8, hdr8, mbw, mbh = flagship_inputs(dev)
    nparts, nmb = cs.PARTITIONS, mbw * mbh
    tok = {n: tile(tok8, n, cs.BATCH) for n in BATCHES}
    hdr = {n: tile(hdr8, n, cs.BATCH) for n in BATCHES}
    want8 = token_ops.encode_coeff_partitions_plain(*(a.cpu() for a in tok8), mbw, mbh, nparts,
                                                    token_ops.token_budget(nmb, nparts))
    cap = int(want8.n_bytes.max())
    want8 = want8._replace(data=want8.data[..., :cap])
    hdr_want8 = token_ops.encode_mb_headers(*(a.cpu() for a in hdr8), mbw, mbh)
    hcap = hdr_want8.data.shape[-1]
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

    def same(got, want, n):
        """got (batch n) equals the batch-8 twin tiled or cut to n."""
        return all(torch.equal(g.cpu(), w.repeat(max(1, n // cs.BATCH), *([1] * (w.dim() - 1)))
                               [:n]) for g, w in zip(got, want))

    def longest(n_ops, n):
        return int(n_ops[:n].max())  # tiles repeat batch 8's lanes

    out = {"card": card, "csrc": str(args.csrc) if args.csrc else None, "versions": {}}
    step_ns = None
    for name, (lib, ptxas) in libs.items():
        k14_ops = srcs[name][2]
        lib.webp_coeff_tokens.argtypes = [Pt, Lg, Pt, Pt, Pt, Pt, Pt, I, I, I, I, I, I, Pt, Pt, Pt,
                                          Pt]
        lib.webp_mb_headers.argtypes = ([Pt, Lg, Pt, Lg, Pt, Lg, Pt, Lg, Pt, Lg, Pt, Pt, I, I, I,
                                         I, I, Pt, Pt] + ([Pt, I] if k14_ops else []) + [Pt, Pt])
        lib.webp_bool_lanes.argtypes = [Pt, Pt, Pt, I, I, Pt, I, Pt, Pt, Pt, Pt]
        consts = _build.device_constant("token_consts", token_ops.TOKEN_CONSTS_NP, dev)
        hconsts = _build.device_constant("header_consts", token_ops.HEADER_CONSTS_NP, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rec = {"ptxas": ptxas}

        def k13(n, lib=lib):
            lm, y2, y, uv, pf = tok[n]
            info = torch.empty((n, nparts, 6), dtype=torch.int64, device=dev)
            data = torch.zeros((n, nparts, cap), dtype=torch.uint8, device=dev)
            marks = torch.empty((n, nparts, boolenc2.carry_words(cap)), dtype=torch.int32,
                                device=dev)
            check(lib.webp_coeff_tokens(lm.data_ptr(), nmb, y2.data_ptr(), y.data_ptr(),
                                        uv.data_ptr(), pf.data_ptr(), consts.data_ptr(),
                                        consts.numel(), mbw, mbh, n, nparts, cap, data.data_ptr(),
                                        marks.data_ptr(), info.data_ptr(), stream), "K13")
            return boolenc2.Lanes.from_fields(info, data)

        def k14(n, lib=lib, k14_ops=k14_ops):
            lm, bp, cm, sid, sk, params = hdr[n]
            info = torch.empty((n, 6), dtype=torch.int64, device=dev)
            data = torch.zeros((n, hcap), dtype=torch.uint8, device=dev)
            marks = torch.empty((n, boolenc2.carry_words(hcap)), dtype=torch.int32, device=dev)
            op_cap = token_ops.header_op_capacity(nmb)
            ops = torch.empty((n, op_cap), dtype=torch.int16, device=dev)
            extra = [ops.data_ptr(), op_cap] if k14_ops else []
            check(lib.webp_mb_headers(lm.data_ptr(), nmb, bp.data_ptr(), nmb * 16, cm.data_ptr(),
                                      nmb, sid.data_ptr(), nmb, sk.data_ptr(), nmb,
                                      params.data_ptr(), hconsts.data_ptr(), hconsts.numel(), mbw,
                                      mbh, n, hcap, data.data_ptr(), marks.data_ptr(), *extra,
                                      info.data_ptr(), stream), "K14")
            return boolenc2.Lanes.from_fields(info, data)

        def k15(lib=lib):
            info = torch.empty((n_lanes, 6), dtype=torch.int64, device=dev)
            data = torch.zeros((n_lanes, 4096), dtype=torch.uint8, device=dev)
            marks = torch.empty((n_lanes, boolenc2.carry_words(4096)), dtype=torch.int32,
                                device=dev)
            check(lib.webp_bool_lanes(*(a.data_ptr() for a in k15_in), steps, n_lanes,
                                      k15_state.data_ptr(), 4096, data.data_ptr(),
                                      marks.data_ptr(), info.data_ptr(), stream), "K15")
            return boolenc2.Lanes.from_fields(info, data)

        for kname, fn, want in (("k13", k13, want8), ("k14", k14, hdr_want8)):
            for n in BATCHES:
                got = fn(n)
                torch.cuda.synchronize()
                if not same(got, want, n):
                    raise AssertionError(f"{name}: {kname} differs from the plain twin at "
                                         f"batch {n}")
                rec[f"{kname}_b{n}_ms"] = time_ms(lambda fn=fn, n=n: fn(n))
        got = k15()
        torch.cuda.synchronize()
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, k15_want)):
            raise AssertionError(f"{name}: k15 differs from the plain twin")
        rec["k15_ms"] = time_ms(k15)

        if name == "package":  # the coder step alone, and the chain floors
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
            rec["k13_resident_ctas"] = lib.webp_coeff_tokens_resident()
        if step_ns is not None:
            for kname, want in (("k13", want8), ("k14", hdr_want8)):
                for n in BATCHES:
                    rec[f"{kname}_floor_b{n}_ms"] = longest(want.n_ops, n) * step_ns / 1e6
        for kname, want in (("k13", want8), ("k14", hdr_want8)):
            for n in BATCHES:
                rec[f"{kname}_ns_per_op_b{n}"] = (rec[f"{kname}_b{n}_ms"] * 1e6
                                                  / longest(want.n_ops, n))
        if name.endswith("_probe"):
            lib.webp_k13_probe.argtypes = [Pt, I]
            check(lib.webp_k13_probe_clear(), "probe clear")
            k13(cs.BATCH)
            k14(cs.BATCH)
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * (1 << 16))()
            check(lib.webp_k13_probe(buf, 1 << 16), "probe copy")
            recs = [buf[i * N_PROBE:(i + 1) * N_PROBE] for i in range(cs.BATCH * nparts)]
            lane = int(want8.n_ops.reshape(-1).argmax())  # the longest lane
            ops_l = int(want8.n_ops.reshape(-1)[lane])
            prb = {k: recs[lane][i] for k, i in RING_PHASES.items()}
            mbs = recs[lane][8]
            img = int(hdr_want8.n_ops.argmax())  # the image with the most header ops
            h = buf[K14_PROBE + img * N_PROBE:K14_PROBE + (img + 1) * N_PROBE]
            if h[3] != int(hdr_want8.n_ops[img]):
                raise AssertionError(f"K14's probe counted {h[3]} ops, not "
                                     f"{int(hdr_want8.n_ops[img])}")
            rec["probe"] = {
                "k13_lane_ops": ops_l,
                "k13_cycles_per_op": {k: round(v / ops_l, 1) for k, v in prb.items()
                                      if k.startswith("cod")},
                "k13_producer_cycles_per_mb": {k: round(v / max(1, mbs), 1)
                                               for k, v in prb.items() if not k.startswith("cod")},
                "k14_image_ops": h[3],
                "k14_count_write_cycles": h[0],
                "k14_coder_cycles_per_op": round((h[1] - h[2]) / h[3], 1),
                "k14_coder_wait_cycles_per_op": round(h[2] / h[3], 1),
            }
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

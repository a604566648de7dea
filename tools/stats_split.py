#!/usr/bin/env python3
"""Time the flagship's statistics kernels on one NVIDIA GPU: K8 analysis
(`webp_tpu_torch/csrc/analysis.cu`, the segment alphas) and K6 token_stats
(`csrc/token_stats.cu`, pass 1's token statistics), each beside an earlier
commit's build of the same kernel; and rank the flagship kernels that no
redesign has reached by their own device time.

    python3 tools/stats_split.py [--rank] [--csrc DIR [--probe] [--segs 8,16]] [--batches 8,64]
                                 [--out FILE]

Inputs are `chip_smoke.py`'s at 768x512, tiled to each batch: the decode's
seeded random keyframes (normal loop filter) parsed on the host, and the
flagship encode's seeded synthetic frames (Q75 m4, segments on) through
K8, the host k-means and K5's pass 1 on the card.

--rank times K1 residual, K4 yuv2rgb, K6 token_stats, K7 enc_tables and
K8 analysis through their wrappers in three rounds: each call by CUDA
events (the wrapper's host work included) and its kernels' device time by
the profiler, beside the kernel's bound, with flagship launches x (device
time - bound), the rule's ranking.

--csrc DIR builds DIR (an earlier commit's `webp_tpu_torch/csrc`, from
`git archive <commit> webp_tpu_torch/csrc` unpacked under `build/`) into
`build/stats_split/parent/` beside the package's sources in
`build/stats_split/package/`, and times both builds' K8 and K6 on the same
inputs in turns (parent, package, package, parent): each launch through
the C entry point with its outputs and scratch allocated as its wrapper
does (CUDA events over the call), and its device time by the profiler.
The parent's outputs must equal the package's.

--probe adds `clock64()` probes to the package's copies of the two
kernels: per CTA, thread 0's cycles from the kernel's start to the end of
each phase (K8: stage, rounds, flush; K6: stage, contexts, lists, count,
flush), the means over CTAs printed.

--segs 8,16,... also times the package's kernels with CTAs of that many
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
RANKED = ("residual", "yuv2rgb", "token_stats", "enc_tables", "analysis")
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
PARENT_SIGNATURES = {  # the one-warp-per-MB K8 and one-thread-per-block K6 (commit 3066949)
    "webp_analysis": [_P, _L, _P, _L, _P, _L, _I, _I, _I, _P, _P, _P],
    "webp_token_stats": [_P, _L, _P, _L, _P, _P, _P, _I, _I, _I, _P, _P],
}
KERNEL_NAMES = {"analysis": ["analysis_kernel"], "token_stats": ["token_stats_kernel"]}

# Probes: thread 0 of each CTA stores clock64() - its start at the end of
# each phase.  (file, anchor, inserted after the anchor); each anchor must
# occur exactly once.
N_PROBE, MAX_CTAS = 5, 65536
PROBE_DECL = f"""
static __device__ long long stats_probe[{MAX_CTAS} * {N_PROBE}];
#define PROBE(k) do {{ if (threadIdx.x == 0) stats_probe[((blockIdx.z * gridDim.y + blockIdx.y) \
    * gridDim.x + blockIdx.x) * {N_PROBE} + (k)] = clock64() - probe_t0; }} while (0)
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
          "token_stats": ("stage", "contexts", "lists", "count", "flush")}
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
}
PTXAS_NAMES = {"analysis_kernel": "analysis", "token_stats_kernel": "token_stats"}


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


def decode_inputs(dev, batch: int):
    """K1's arguments, its outputs, and K4's planes and geometry."""
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
    return k1_args, (res, do_sub), planes, (width, height)


def encode_inputs(dev, batch: int):
    """The flagship's planes, K8's outputs, pass 1's token_stats arguments
    (with the skip flags) and its statistics' adapted probabilities."""
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
    pass1 = encode_analysis_batch(y, u, v, P, default, min(edev.n_try_for(METHOD), 3), False, sid)
    mbw, mbh = WIDTH // 16, HEIGHT // 16
    stat_args = (pass1["luma_mode"], pass1["y2_levels"], pass1["y_levels"], pass1["uv_levels"],
                 edev.skip_flags(pass1), mbw, mbh)
    stats = token_stats(*stat_args)
    probs = torch.from_numpy(edev.adapt_probs(stats[0].cpu().numpy(),
                                              stats[1].cpu().numpy())).to(dev)
    return (y, u, v), alphas, stat_args, stats, probs


def ranked_calls(dev, batch: int) -> dict:
    """name -> (call, kernel names, bound record) of the ranked kernels."""
    import chip_smoke as cs
    from webp_tpu_torch.ops import residual
    from webp_tpu_torch.ops.analysis import analyze_alphas_batch
    from webp_tpu_torch.ops.enc_params import EncTables
    from webp_tpu_torch.ops.enc_tables import enc_tables
    from webp_tpu_torch.ops.token_stats import token_stats
    from webp_tpu_torch.ops.yuv import fancy_yuv420_to_rgb

    k1_args, k1_out, planes, (width, height) = decode_inputs(dev, batch)
    rgb = fancy_yuv420_to_rgb(*planes, width, height)
    (y, u, v), alphas, stat_args, stats, probs = encode_inputs(dev, batch)
    tables = enc_tables(probs)
    nmb = (WIDTH // 16) * (HEIGHT // 16)
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
                    cs.device_ms(fn, 20, cs.FLAGSHIP_DEVICE[k])))
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


def split(dev, card: str, batches, lib, parent, probe: bool, segs=()) -> dict:
    """K8 and K6 of the package beside the parent's, in turns, per batch."""
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

    out = {}
    for batch in batches:
        planes, _, stat_args, _, _ = encode_inputs(dev, batch)
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
                reader = getattr(lib, f"webp_{k}_probe")
                reader.argtypes, reader.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
                ctas = batch * mbh * -(-mbw // seg)
                n = N_PROBE * ctas
                buf = (ctypes.c_longlong * n)()
                reader(buf, n)  # read and zero
                calls[k]["package"]()
                torch.cuda.synchronize()
                if reader(buf, n) != 0:
                    raise RuntimeError("the probe read failed")
                ends = [statistics.mean(buf[c * N_PROBE + p] for c in range(ctas))
                        for p in range(len(PHASES[k]))]
                cyc = {ph: ends[i] - (ends[i - 1] if i else 0) for i, ph in enumerate(PHASES[k])}
                cyc["total"] = ends[-1]
                rec[k]["cycles_per_cta"] = cyc
                print(f"batch {batch}: {k} probe, mean cycles a CTA by phase "
                      f"{({p: round(c) for p, c in cyc.items()})} ({card})", flush=True)
        out[batch] = rec
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rank", action="store_true", help="device-time ranking of K1, K4, K6-K8")
    ap.add_argument("--csrc", type=Path, help="an earlier csrc whose K8 / K6 to time beside")
    ap.add_argument("--probe", action="store_true", help="clock64() probes per phase")
    ap.add_argument("--segs", help="also time the package with CTAs of these MBs a row")
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
        for name, argtypes in PARENT_SIGNATURES.items():
            getattr(parent, name).argtypes = argtypes
            getattr(parent, name).restype = ctypes.c_int
    lib = build(_build, package_csrc, ROOT / "build" / "stats_split" / "package", args.probe)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    batches = [int(b) for b in args.batches.split(",")]
    out = {"card": card, "ptxas": ptxas_lines(_build.PTXAS_REPORT)}
    if args.rank:
        out["rank"] = rank(dev, card, batches)
    if parent is not None:
        out["parent_ptxas"] = parent_ptxas
        out["split"] = split(dev, card, batches, lib, parent, args.probe,
                             [int(x) for x in args.segs.split(",")] if args.segs else ())
    for who in ("ptxas", "parent_ptxas"):
        for line in out.get(who, []):
            print(f"{who} {line}")
    print(smi)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

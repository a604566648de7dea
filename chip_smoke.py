#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (webp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the host entropy library (g++) and the decode kernels
(`webp_tpu_torch/csrc`, nvcc), writes four distinct seeded 768x512 VP8
keyframes (`tests/random_vp8.py`: I4 and I16 macroblocks, segments,
|level| > 127 escapes, several token partitions; two with the normal loop
filter, two with the simple one) and decodes a batch of 8 of each kind
through the port's main path (`dispatch_decode_batch`, out="rgb" and
out="yuv") on the card.  It checks the output bit-exact against the port's
plain torch decode of the same payloads on the CPU (which the tests hold to
the JAX package and its scalar decoder) and the RGB also against the host's
C++ YUV->RGB conversion of the YUV output, checks each kernel (K1 residual,
K2 recon, K3 loop filter in both kinds, K4 yuv2rgb) bit-exact against its
plain torch twin on the same card inputs, and shows that the main path
launched every kernel.  It imports neither jax nor the JAX package.

Prints the card's name and power limit, per-kernel and per-batch timings
(CUDA events; kernel beside plain twin), one JSON line of kernel records,
and, last, {"ok": true, "device": {...}}.  Exits non-zero, without that
line, when there is no CUDA device or any phase fails.  Needs no network.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WIDTH, HEIGHT = 768, 512
BATCH = 8
SEEDS = {False: (101, 202), True: (303, 404)}  # simple filter -> distinct frames
ESCAPES = 32  # |level| > 127 per frame

KERNELS = [
    # name, source, replaced TPU kernel (file:line)
    ("residual", "webp_tpu_torch/csrc/residual.cu", "webp_tpu/decode/device.py:509"),
    ("recon", "webp_tpu_torch/csrc/recon.cu", "webp_tpu/ops/wavefront2.py:152"),
    ("loopfilter", "webp_tpu_torch/csrc/loopfilter.cu", "webp_tpu/ops/loopfilter2.py:192"),
    ("yuv2rgb", "webp_tpu_torch/csrc/yuv2rgb.cu", "webp_tpu/ops/jax_ops.py:189"),
]


def _import_paths() -> None:
    for p in (str(ROOT), str(ROOT / "tests")):
        if p not in sys.path:
            sys.path.insert(0, p)


def make_payloads(width: int, height: int, simple: bool):
    """Distinct seeded random keyframes and their (I4, I16) MB counts."""
    _import_paths()
    from random_vp8 import random_keyframe

    out = []
    for seed in SEEDS[simple]:
        payload, content = random_keyframe(width, height, seed, simple=simple, escapes=ESCAPES)
        n_i4 = int((content["luma_mode"] == 4).sum())
        out.append((payload, n_i4, content["luma_mode"].size - n_i4))
    return out


def cpu_reference(payloads):
    """(RGB [n, h, w, 3], packed YUV [n, ...]) numpy of the port's plain torch
    decode on the CPU."""
    _import_paths()
    from webp_tpu_torch.decode import device as tdev
    from webp_tpu_torch.ops.yuv import fancy_yuv420_to_rgb

    batch = tdev.parse_levels_batch(payloads)
    mbw, mbh, _, width, height = tdev.geometry(batch["headers"])
    yuv = tdev.decode_core(tdev.to_device_batch(batch, "cpu"), "yuv")
    rgb = fancy_yuv420_to_rgb(*tdev.split_planes(yuv, mbw, mbh), width, height)
    return rgb.numpy(), yuv.numpy()


def time_ms(fn, reps: int, setup=None):
    """Median device time of fn() over `reps` runs, in ms (CUDA events);
    setup() runs before each run, outside the timed span."""
    import torch

    times = []
    for rep in range(reps + 1):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        if rep:  # the first run warms up
            times.append(start.elapsed_time(stop))
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    _import_paths()
    from webp_tpu_torch import _build
    from webp_tpu_torch.decode import device as tdev
    from webp_tpu_torch.io import native
    from webp_tpu_torch.ops import residual
    from webp_tpu_torch.ops.loopfilter import loop_filter_, loop_filter_plain_
    from webp_tpu_torch.ops.wavefront import recon_, recon_plain_
    from webp_tpu_torch.ops.yuv import fancy_yuv420_to_rgb, fancy_yuv420_to_rgb_plain

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. Build the host library and the kernels from the checkout.
    t0 = time.perf_counter()
    native.load()
    _build.load()
    print(f"build + load: {time.perf_counter() - t0:.1f} s", flush=True)

    # 2. The card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    print(f"card: {card}", flush=True)

    # 3. Inputs: two distinct frames per filter kind, tiled into batches of
    #    8, and the plain CPU decode of the distinct frames.
    t0 = time.perf_counter()
    batches, refs = {}, {}
    for simple in (False, True):
        made = make_payloads(WIDTH, HEIGHT, simple)
        for payload, i4, i16 in made:
            if i4 == 0 or i16 == 0:
                raise AssertionError(f"expected I4 and I16 MBs, got {i4} / {i16}")
            print(f"payload ({'simple' if simple else 'normal'} filter): {len(payload)} bytes, "
                  f"{i4} I4 MBs, {i16} I16 MBs", flush=True)
        distinct = [m[0] for m in made]
        batches[simple] = [distinct[i % len(distinct)] for i in range(BATCH)]
        refs[simple] = cpu_reference(distinct)
    print(f"write + plain CPU decode: {time.perf_counter() - t0:.1f} s", flush=True)
    host = tdev.parse_levels_batch(batches[False])
    nmb = (WIDTH + 15) // 16 * ((HEIGHT + 15) // 16)
    n_esc = int((host["esc_pos"] < nmb * 400).sum(1).min())
    if host["bitmap"] is None or n_esc == 0:
        raise AssertionError(f"main path must take the sparse form with escapes ({n_esc})")

    # 4. The main path, counted: both filter kinds, both outputs.
    _build.reset_launches()
    outs = {(simple, out): tdev.dispatch_decode_batch(batches[simple], out=out, device=dev)
            for simple in (False, True) for out in ("rgb", "yuv")}
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing} kernel: {launches}")
    mbw, mbh = (WIDTH + 15) // 16, (HEIGHT + 15) // 16
    for (simple, out), got in outs.items():
        if got.device.type != "cuda":
            raise AssertionError(f"{out} output on {got.device}")
        want = refs[simple][0 if out == "rgb" else 1]
        got_h = got.cpu().numpy()
        if got_h.shape != (BATCH, *want.shape[1:]):
            raise AssertionError(f"{out} shape {got_h.shape}")
        for i in range(BATCH):
            if not (got_h[i] == want[i % len(want)]).all():
                raise AssertionError(f"image {i} ({out}, simple={simple}) differs from the "
                                     "plain CPU decode")
        if out == "yuv":
            host_rgb = tdev.yuv_packed_to_rgb(got_h, mbw, mbh, WIDTH, HEIGHT)
            if not (host_rgb == outs[(simple, "rgb")].cpu().numpy()).all():
                raise AssertionError("K4 RGB differs from the host C++ conversion")
    print(f"main path: bit-exact vs the plain CPU decode on 2 x {BATCH} images "
          f"(normal and simple filter, rgb and yuv); launches {launches}", flush=True)

    # 5. Each kernel against its plain twin, on the main path's inputs.
    d = tdev.to_device_batch(host, dev)
    _, _, simple, width, height = tdev.geometry(host["headers"])
    f = tdev.field_views(d["u8buf"], nmb)
    mb = (f["segment_ids"], f["luma_mode"], f["skipped"], f["non_zero"])
    k1_args = [d[k] for k in ("bitmap", "vals", "esc_pos", "esc_val", "qtab")] + list(mb)
    res, do_sub = residual.residuals_sparse(*k1_args)
    res_p, do_sub_p = residual.residuals_sparse_plain(*k1_args)
    i16buf = torch.from_numpy(host["i16buf"]).to(dev)
    dense = residual.residuals_dense(i16buf, *mb)
    err = {"residual": max(max_abs_err(res, res_p), max_abs_err(do_sub, do_sub_p),
                           max_abs_err(dense[0], res_p), max_abs_err(dense[1], do_sub_p))}

    def planes():
        packed = torch.zeros((BATCH, nmb * 384), dtype=torch.uint8, device=dev)
        return tdev.split_planes(packed, mbw, mbh)

    recon_args = (res, f["luma_mode"], f["bpred"], f["chroma_mode"])
    rec, rec_p = planes(), planes()
    target, target_p = planes(), planes()
    recon_(*rec, *recon_args)
    recon_plain_(*rec_p, *recon_args)
    err["recon"] = max(max_abs_err(a, b) for a, b in zip(rec, rec_p))

    lf_args = (f["level"], f["interior"], f["hev"], do_sub)
    err["loopfilter"] = 0
    filtered = None
    for kind in (simple, not simple):
        got = [p.clone() for p in rec]
        want = [p.clone() for p in rec]
        loop_filter_(*got, *lf_args, kind)
        loop_filter_plain_(*want, *lf_args, kind)
        err["loopfilter"] = max(err["loopfilter"], *(max_abs_err(a, b) for a, b in zip(got, want)))
        if kind == simple:
            filtered = got
    out = fancy_yuv420_to_rgb(*filtered, width, height)
    out_p = fancy_yuv420_to_rgb_plain(*filtered, width, height)
    err["yuv2rgb"] = max(max_abs_err(out, out_p), max_abs_err(out, outs[(False, "rgb")]))
    torch.cuda.synchronize()
    bad = {k: e for k, e in err.items() if e != 0}
    if bad:
        raise AssertionError(f"kernels differ from their plain twins: {bad}")
    print(f"kernels vs plain twins (bit-exact, tolerance 0): {err}", flush=True)

    # 6. Timings, kernel beside plain twin, at the main path's shapes.  The
    #    filter works in place, so each run starts from fresh unfiltered planes.
    work = [p.clone() for p in rec]

    def fresh():
        for w, r in zip(work, rec):
            w.copy_(r)

    ms = {
        "residual": time_ms(lambda: residual.residuals_sparse(*k1_args), 50),
        "recon": time_ms(lambda: recon_(*target, *recon_args), 20),
        "loopfilter": time_ms(lambda: loop_filter_(*work, *lf_args, simple), 20, fresh),
        "yuv2rgb": time_ms(lambda: fancy_yuv420_to_rgb(*filtered, width, height), 50),
    }
    plain_ms = {
        "residual": time_ms(lambda: residual.residuals_sparse_plain(*k1_args), 5),
        "recon": time_ms(lambda: recon_plain_(*target_p, *recon_args), 2),
        "loopfilter": time_ms(lambda: loop_filter_plain_(*work, *lf_args, simple), 2, fresh),
        "yuv2rgb": time_ms(lambda: fancy_yuv420_to_rgb_plain(*filtered, width, height), 5),
    }
    for name, _, _ in KERNELS:
        print(f"{name}: {ms[name]:.4f} ms kernel, {plain_ms[name]:.4f} ms plain "
              f"(batch {BATCH} at {WIDTH}x{HEIGHT}; {card})", flush=True)
    # K3's branches depend on the pixels: its time on planes it has already
    # filtered, beside the time on the main path's planes above.
    refilter_ms = time_ms(lambda: loop_filter_(*work, *lf_args, simple), 20)
    print(f"loopfilter on already-filtered planes: {refilter_ms:.4f} ms kernel ({card})",
          flush=True)

    def plain_core():
        r, ds = residual.residuals_sparse_plain(*k1_args)
        p = planes()
        recon_plain_(*p, r, f["luma_mode"], f["bpred"], f["chroma_mode"])
        loop_filter_plain_(*p, f["level"], f["interior"], f["hev"], ds, simple)
        return fancy_yuv420_to_rgb_plain(*p, width, height)

    core_ms = time_ms(lambda: tdev.decode_core(d, "rgb"), 20)
    core_plain_ms = time_ms(plain_core, 2)
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        tdev.dispatch_decode_batch(batches[False], out="rgb", device=dev)
    torch.cuda.synchronize()
    e2e_ms = (time.perf_counter() - t0) * 1000 / reps
    print(f"decode_core (device, uploaded batch): {core_ms / BATCH:.4f} ms/img kernels, "
          f"{core_plain_ms / BATCH:.4f} ms/img plain twins ({card})", flush=True)
    print(f"dispatch_decode_batch (host parse + upload + kernels, host clock): "
          f"{e2e_ms / BATCH:.4f} ms/img ({card})", flush=True)

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "webp_tpu"))
    if leaked:
        raise AssertionError(f"the smoke run imported {leaked}")

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": ms[name], "plain_ms": plain_ms[name]}
        for name, source, replaces in KERNELS
    ]}
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

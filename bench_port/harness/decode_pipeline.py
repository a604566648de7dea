"""The pipelined batch decode: `bench.py`'s decode loop (`bench.py:290-335`)
over seeded random VP8 keyframes, as `lane.decode_lane` runs it.

The lane runs `dispatch_decode_batch(payloads, out="rgb")` (the host parse,
the upload, K1, `recon_filter`, K4) of batch i+1 while the caller waits on
an event until batch i's RGB is ready on the device; the RGB stays there,
as vision work that consumes it on the card would have it.  Batch i holds
the pool's payloads (stride * i + j) % pool, j < batch.  The keyframes
(`random_vp8`: the normal loop filter, the configuration's token
partitions, coded runs of the assumed `keyframe_run_p`) are written in
worker processes during set-up.

`correct`: no image is missing from any batch back after the window
opened, and the RGB of `sample_batches` of them, drawn from the seed as
they come back, equals the reference decode of each payload
(`vp8ref.decode`, in worker processes) in every pixel.
"""

from __future__ import annotations

import random
import time

import numpy as np

from . import jobs
from .lane import decode_lane
from .loop import Outcome, Window, batch_order, device_info, log_err, pool, sub_seeds
from .readings import Readings
from .roofline import decode_work
from .trace import Tracer


def payloads_of(seed: int, width: int, height: int, n: int, partitions: int, run_p: float,
                workers: int):
    """The pool of n distinct keyframes of a seed (normal loop filter)."""
    log2_parts = {1: 0, 2: 1, 4: 2, 8: 3}[partitions]
    args = [(width, height, s % (1 << 31), False, log2_parts, run_p) for s in sub_seeds(seed, n)]
    with pool(workers) as ex:
        return list(ex.map(jobs.keyframe, args))


def run(cell, seed: int, seconds: float, trace: bool, device: str, t_start: float,
        control: bool = False, fault=None, log=log_err) -> Outcome:
    """One run of the cell.  `control` puts the reference's decode with
    simple chroma upsampling in the place of the port's output;
    `fault(i, rgb)` alters what the timed path returns (the harness's own
    tests)."""
    import torch

    from webp_tpu_torch.decode import device as ddev

    cfg, mix = cell.config, cell.traffic
    width, height = cfg["width"], cfg["height"]
    batch, n_pool, stride = mix["batch"], mix["pool"], mix["stride"]
    dev = torch.device(device)
    payloads = payloads_of(seed, width, height, n_pool, cfg["partitions"],
                           cfg["assumed"]["keyframe_run_p"], mix["gen_workers"])

    def order(i):
        return batch_order(i, batch, n_pool, stride)

    def dispatch(i):
        rgb = ddev.dispatch_decode_batch([payloads[k] for k in order(i)], out="rgb", device=dev)
        if dev.type != "cuda":
            return rgb, None
        done = torch.cuda.Event()
        done.record()
        return rgb, done

    tracer = Tracer(trace, dev.type == "cuda")
    window = Window(seconds, mix["warmup_rounds"], tracer)
    rng = random.Random(seed)
    kept, seen = {}, [0]
    n_keep = mix["sample_batches"]
    images = {}

    def ready(i, handle):
        rgb, done = handle
        if done is not None:
            done.synchronize()
        if fault is not None:
            rgb = fault(i, rgb)
        images[i] = int(rgb.shape[0])
        if window.t_open is not None:  # a reservoir of the batches since the window opened
            seen[0] += 1
            if len(kept) < n_keep:
                kept[i] = rgb
            else:
                j = rng.randrange(seen[0])
                if j < n_keep:
                    del kept[sorted(kept)[j]]
                    kept[i] = rgb
        return None

    with tracer:
        lane_log = decode_lane(dispatch, ready, window.more)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    device_desc = device_info(torch, dev)
    t_open = window.t_open
    readings = Readings(seconds, t_open, lane_log, {i: batch for i in lane_log.done},
                        t_open - t_start)
    summary = tracer.summary(t_open, seconds, lane_log.spans) if trace else None
    outputs = {i: np.asarray(t.cpu()) for i, t in sorted(kept.items())}
    kept.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # The check, after the window.
    checked = sorted(i for i, t in lane_log.done.items() if t > t_open)
    t0 = time.perf_counter()
    with pool(mix["check_workers"]) as ex:
        ref = list(ex.map(jobs.reference_decode, [(p, "bilinear") for p in payloads]))
        if control:
            simple = list(ex.map(jobs.reference_decode, [(p, "simple") for p in payloads]))
            outputs = {i: np.stack([simple[k][0] for k in order(i)]) for i in outputs}
    log(f"[check] the reference decoded {n_pool} payloads in {time.perf_counter() - t0:.1f} s; "
        f"{len(outputs)} batches compared: {sorted(outputs)}")
    missing = sum(max(0, batch - images[i]) for i in checked)
    differing, worst = 0, 0
    for i, rgb in outputs.items():
        for j, k in enumerate(order(i)[:len(rgb)]):
            want = ref[k][0]
            if rgb[j].shape != want.shape:
                differing += 1
                worst = max(worst, 255)
                continue
            d = int(np.abs(rgb[j].astype(np.int16) - want.astype(np.int16)).max())
            differing += d > 0
            worst = max(worst, d)
    if trace:
        work = {k: decode_work(width, height, ref[k][1], len(payloads[k])) for k in range(n_pool)}
        readings.work_per_input = work
        readings.work = tuple(sum(work[k][n] for i in readings.batches_done() for k in order(i))
                              for n in (0, 1))
    readings.trace = summary
    checks = {"images_missing": (missing, 0), "images_differing": (differing, 0),
              "max_abs_diff": (worst, 0)}
    return Outcome(readings, batch * len(checked), missing + differing, checks, device_desc)

"""The pipelined batch encode: `bench.py`'s encode loop (`bench.py:196-250`)
over seeded synthetic frames, as `lane.encode_lane` runs it.

The lane makes every dispatch: the colour conversion (`rgb_to_planes`) and
`dispatch_seg_results` of batch i+1 in `early_chain`, its
`dispatch_frames_lossy_batch` in `chain`, and every `fetch`; the caller's
thread finishes batch i-1 (`finish_frames_lossy_batch`, or with device
tokens `finish_frames_tokens`) and wraps each payload as a RIFF WebP file.
Batch i holds the pool's frames (stride * i + j) % pool, j < batch.

`correct`: every file of a batch that came back after the window opened
equals the reference's file of its frame (`vp8ref.encoder`, frames
re-encoded from their RGB in worker processes), and none is missing.
"""

from __future__ import annotations

import math
import time

from vp8ref.decoder import mb_modes

from . import jobs
from .lane import encode_lane
from .loop import Outcome, Window, batch_order, device_info, log_err, pool, riff, sub_seeds
from .readings import Readings
from .roofline import encode_work
from .synthetic_rgb import synthetic_frame
from .trace import Tracer

RIFF_HEADER = 20  # "RIFF", size, "WEBP", "VP8 ", size


def payload_of(file: bytes) -> bytes:
    """The VP8 payload of a file that `loop.riff` wrapped."""
    return file[RIFF_HEADER:RIFF_HEADER + int.from_bytes(file[16:RIFF_HEADER], "little")]


def frames_of(seed: int, width: int, height: int, n: int, noise: int) -> list:
    """The pool of n distinct frames of a seed, with per-pixel noise up to
    `noise` (the configuration's assumed `rgb_noise`)."""
    return [synthetic_frame(width, height, s % (1 << 31), noise) for s in sub_seeds(seed, n)]


def run(cell, seed: int, seconds: float, trace: bool, device: str, t_start: float,
        control: bool = False, fault=None, log=log_err) -> Outcome:
    """One run of the cell.  `control` runs the port's cheaper path (method
    3: three B modes tried and no trellis) in its place; `fault(i, files)`
    alters what the timed path returns (the harness's own tests)."""
    import torch

    from webp_tpu_torch.encode import device as edev

    cfg, mix = cell.config, cell.traffic
    width, height = cfg["width"], cfg["height"]
    quality, method, parts = cfg["quality"], cfg["method"], cfg["partitions"]
    segments, tokens = cfg["segments"] > 1, bool(cfg["device_tokens"])
    run_method = min(method - 1, 3) if control else method
    batch, n_pool, stride = mix["batch"], mix["pool"], mix["stride"]
    dev = torch.device(device)
    frames = frames_of(seed, width, height, n_pool, cfg["assumed"]["rgb_noise"])

    def order(i):
        return batch_order(i, batch, n_pool, stride)

    planes = {}

    def seg_dispatch(i):
        planes[i] = edev.rgb_to_planes([frames[k] for k in order(i)])
        if not segments:
            return lambda: None
        return edev.dispatch_seg_results(planes[i], quality, device=dev)

    def dispatch(i, segs):
        return edev.dispatch_frames_lossy_batch(planes.pop(i), quality, run_method, True,
                                                segments, device=dev, device_tokens=tokens,
                                                num_partitions=parts, seg_results=segs)

    def finish(i, fetched):
        arrays, probs, segs = fetched
        if tokens:
            payloads = edev.finish_frames_tokens(arrays, probs, quality, width, height, segs)
        else:
            payloads = edev.finish_frames_lossy_batch(arrays, probs, quality, width, height,
                                                      parts, segs)
        files = [riff(p) for p in payloads]
        return fault(i, files) if fault is not None else files

    tracer = Tracer(trace, dev.type == "cuda")
    window = Window(seconds, mix["warmup_rounds"], tracer)
    with tracer:
        lane_log = encode_lane(dispatch, seg_dispatch, finish, window.more)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    device_desc = device_info(torch, dev)
    t_open = window.t_open
    setup_s = t_open - t_start
    readings = Readings(seconds, t_open, lane_log, {i: batch for i in lane_log.done}, setup_s)
    summary = tracer.summary(t_open, seconds, lane_log.spans) if trace else None
    planes.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # The check, after the window: every batch back after it opened.
    checked = sorted(i for i, t in lane_log.done.items() if t > t_open)
    used = sorted({k for i in checked for k in order(i)})
    first = {}
    for i in readings.batches_done():
        for k, f in zip(order(i), lane_log.results[i]):
            first.setdefault(k, f)
    per = math.ceil(len(used) / mix["check_workers"])
    groups = [used[a:a + per] for a in range(0, len(used), per)]
    t0 = time.perf_counter()
    with pool(len(groups)) as ex:
        mode_jobs = {k: ex.submit(mb_modes, payload_of(f)) for k, f in first.items()} \
            if trace else {}
        ref_jobs = [ex.submit(jobs.reference_encode,
                              ([frames[k] for k in g], quality, method, segments, parts))
                    for g in groups]
        ref = {}
        for g, job in zip(groups, ref_jobs):
            ref.update({k: riff(p) for k, p in zip(g, job.result())})
        modes = {k: j.result() for k, j in mode_jobs.items()}
    log(f"[check] the reference encoded {len(used)} frames in {time.perf_counter() - t0:.1f} s "
        f"({len(groups)} workers)")
    missing = sum(max(0, batch - len(lane_log.results[i])) for i in checked)
    differing = sum(f != ref[k] for i in checked for k, f in zip(order(i), lane_log.results[i]))
    if trace:
        work = {k: encode_work(width, height, method, modes[k], len(payload_of(f)))
                for k, f in first.items()}
        readings.work_per_input = work
        readings.work = tuple(sum(work[k][n] for i in readings.batches_done() for k in order(i)
                                  if k in work) for n in (0, 1))
    readings.trace = summary
    sizes = [len(f) for f in first.values()]
    if sizes:
        bits = 8 * sum(len(payload_of(f)) for f in first.values()) / len(sizes) / (width * height)
        log(f"[check] mean file {sum(sizes) / len(sizes):.1f} B ({bits:.4f} bits a pixel) over "
            f"{len(sizes)} distinct frames")
    checks = {"files_missing": (missing, 0), "files_differing": (differing, 0)}
    return Outcome(readings, batch * len(checked), missing + differing, checks, device_desc)

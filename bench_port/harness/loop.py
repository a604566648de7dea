"""What the runners share: seeds, the window, the worker pool, the files'
RIFF container, the device's description and a runner's outcome."""

from __future__ import annotations

import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from typing import NamedTuple

import numpy as np


class Outcome(NamedTuple):
    """A runner's outcome: its `Readings`, the requests attempted and failed,
    the numbers compared {name: (value, limit)} and the device."""
    readings: object
    attempted: int
    failed: int
    checks: dict
    device: dict


def log_err(line: str) -> None:
    """A runner's note for standard error."""
    print(line, file=sys.stderr, flush=True)


def batch_order(i: int, batch: int, pool: int, stride: int) -> list:
    """The pool indices of batch i: (stride * i + j) mod pool, j < batch, so
    that no batch repeats its neighbour."""
    return [(stride * i + j) % pool for j in range(batch)]


def sub_seeds(seed: int, n: int, salt: int = 0) -> list:
    """n seeds for numpy's RandomState (< 2**32) drawn from the run's seed."""
    return [int(s) for s in np.random.SeedSequence([int(seed), salt]).generate_state(n)]


def riff(vp8: bytes) -> bytes:
    """A VP8 payload as a RIFF WebP file."""
    chunk = b"VP8 " + len(vp8).to_bytes(4, "little") + vp8 + (b"\x00" if len(vp8) & 1 else b"")
    return b"RIFF" + (4 + len(chunk)).to_bytes(4, "little") + b"WEBP" + chunk


def pool(workers: int) -> ProcessPoolExecutor:
    """A pool of spawned CPU worker processes (use it in a `with`)."""
    n = max(1, min(int(workers), os.cpu_count() or 1))
    return ProcessPoolExecutor(max_workers=n, mp_context=multiprocessing.get_context("spawn"))


class Window:
    """The measured window of a closed loop: `more(i)` is asked before each
    dispatch of batch i; the window opens when batch i > `warm` is asked
    for (the warm-up rounds are through), and closes `seconds` later, when
    no more batches are dispatched."""

    def __init__(self, seconds: float, warm: int, tracer, clock=time.perf_counter):
        self.seconds, self.warm, self.tracer, self.clock = seconds, warm, tracer, clock
        self.t_open = None
        self.closed = False

    def more(self, i: int) -> bool:
        now = self.clock()
        if self.t_open is None:
            if i > self.warm:
                self.t_open = now
                self.tracer.mark("open")
            return True
        if now >= self.t_open + self.seconds:
            if not self.closed:
                self.closed = True
                self.tracer.mark("close")
            return False
        return True


def device_info(torch, dev) -> dict:
    """The contract's `device`: the platform, the card's name, the cards
    used and the peak of memory allocated on it."""
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}

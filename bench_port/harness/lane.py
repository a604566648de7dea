"""The batch pipelines of `bench.py` as time-bounded loops over any dispatch.

A frozen copy of `tests/pipeline_lane.py` that runs until `more` says stop
instead of a fixed number of rounds, and records every part of a round as
a host-clock span.  `encode_lane` is the encode loop of `bench.py:196-250`:
one lane thread makes every dispatch and fetch and runs the `early_chain`
and `chain` hooks (the next batch's segment dispatch ahead of this batch's
pass 2, its pass 1 right after), while the caller's thread finishes batch
i-1 on the host.  `decode_lane` is the decode loop of `bench.py:290-335`:
the lane parses, uploads and launches batch i+1 while the caller waits for
batch i.
"""

from __future__ import annotations

import functools
import time
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple


class Span(NamedTuple):
    """A part of a round on one thread ("lane" or "main"), host clock."""
    thread: str
    name: str
    batch: int
    t0: float
    t1: float


class LaneLog:
    """What a loop recorded: per batch when its inputs reached the lane
    (`handed`) and when its results were back (`done`), its results, and
    the spans."""

    def __init__(self):
        self.handed, self.done, self.results, self.spans = {}, {}, {}, []

    def span(self, thread: str, name: str, batch: int, t0: float, t1: float) -> None:
        self.spans.append(Span(thread, name, batch, t0, t1))


def encode_lane(dispatch, seg_dispatch, finish, more, clock=time.perf_counter) -> LaneLog:
    """Batches 0, 1, ... through seg_dispatch(i) -> wait() -> seg_results,
    dispatch(i, seg_results) -> fetch, fetch(chain, early_chain) -> fetched
    and finish(i, fetched) -> results, while more(i) says to dispatch batch
    i.  Round r fetches batch r and dispatches batch r+1 from its hooks;
    the caller finishes batch r-1 meanwhile.  Lane spans per round:
    "fetch_wait" the fetch up to `early_chain`, "seg_dispatch",
    "fetch_mid" from `early_chain` to `chain`, "seg_wait", "dispatch",
    "fetch_tail" after `chain`; main spans "finish" and "wait" (for the
    round's fetch).  A batch is handed when its seg_dispatch starts."""
    lane = ThreadPoolExecutor(max_workers=1)
    log = LaneLog()
    holder = {}

    def mark(r, name):
        now = clock()
        log.span("lane", name, r, holder["t"], now)
        holder["t"] = now

    def early(r):
        mark(r, "fetch_wait")
        log.handed[r + 1] = holder["t"]
        holder["segs"] = seg_dispatch(r + 1)
        mark(r, "seg_dispatch")

    def chain(r):
        mark(r, "fetch_mid")
        segs = holder.pop("segs")()
        mark(r, "seg_wait")
        holder["next"] = dispatch(r + 1, segs)
        mark(r, "dispatch")

    def first():
        log.handed[0] = clock()
        return dispatch(0, seg_dispatch(0)())

    def run(fetch, r, go_on):
        holder["t"] = clock()
        got = fetch(functools.partial(chain, r) if go_on else None,
                    functools.partial(early, r) if go_on else None)
        mark(r, "fetch_tail")
        return got

    def finish_one(i, fetched):
        t0 = clock()
        log.results[i] = finish(i, fetched)
        log.done[i] = clock()
        log.span("main", "finish", i, t0, log.done[i])

    try:
        fetch = lane.submit(first).result() if more(0) else None
        r, prev = 0, None
        while fetch is not None:
            go_on = more(r + 1)
            fut = lane.submit(run, fetch, r, go_on)
            if prev is not None:
                finish_one(r - 1, prev)
            t0 = clock()
            prev = fut.result()
            log.span("main", "wait", r, t0, clock())
            fetch = holder.pop("next", None)
            r += 1
        if prev is not None:
            finish_one(r - 1, prev)
    finally:
        lane.shutdown()
    return log


def decode_lane(dispatch, ready, more, clock=time.perf_counter) -> LaneLog:
    """Batches 0, 1, ... through dispatch(i) -> handle on the lane and
    ready(i, handle) -> result on the caller's thread, which waits for
    batch i while the lane dispatches batch i+1, while more(i) says to
    dispatch batch i.  Lane span "dispatch"; main spans "wait" (for the
    handle) and "ready".  A batch is handed when its dispatch starts and
    done when ready returns."""
    lane = ThreadPoolExecutor(max_workers=1)
    log = LaneLog()

    def job(i):
        t0 = log.handed[i] = clock()
        try:
            return dispatch(i)
        finally:
            log.span("lane", "dispatch", i, t0, clock())

    try:
        fut, i = (lane.submit(job, 0) if more(0) else None), 0
        while fut is not None:
            t0 = clock()
            handle = fut.result()
            t1 = clock()
            log.span("main", "wait", i, t0, t1)
            fut = lane.submit(job, i + 1) if more(i + 1) else None
            log.results[i] = ready(i, handle)
            log.done[i] = clock()
            log.span("main", "ready", i, t1, log.done[i])
            i += 1
    finally:
        lane.shutdown()
    return log

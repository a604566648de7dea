"""The batch pipelines of `bench.py` as loops over any dispatch (jax-free).

`encode_lane` is the encode loop of `bench.py:196-250`: one lane thread
makes every dispatch and fetch and runs the `early_chain` and `chain`
hooks (the next batch's segment dispatch ahead of this batch's pass 2, its
pass 1 right after), while the caller's thread finishes batch i-1 on the
host.  `decode_lane` is the decode loop of `bench.py:290-335`: the lane
parses, uploads and launches batch i+1 while the caller fetches batch i.
The tests drive the JAX package and the port through them; `chip_smoke.py`
drives the port on the card, with `checked(round, on)` switching
`torch.cuda.set_sync_debug_mode` on around the dispatch halves
(`sync_errors`).
"""

import functools
import time
from concurrent.futures import ThreadPoolExecutor


def _unchecked(round_, on):
    pass


def sync_errors(round_, on):
    """A `checked` for the card: from the second round on, a PyTorch op that
    waits for the device raises inside a dispatch half."""
    import torch

    torch.cuda.set_sync_debug_mode("error" if on and round_ >= 1 else 0)


def encode_lane(n, dispatch, seg_dispatch, finish, checked=_unchecked):
    """Batches 0..n-1 through dispatch(i, seg_results) -> fetch,
    seg_dispatch(i) -> wait() -> seg_results, fetch(chain, early_chain) ->
    fetched and finish(i, fetched) -> payloads.  Round r fetches batch r
    and dispatches batch r+1 from its hooks; checked(r, True) marks where a
    dispatch half of round r begins (the segment dispatch in `early_chain`,
    the fetch from there to `chain`, the dispatch in `chain`) and
    checked(r, False) where it ends; the first dispatch is round -1.

    Returns (payloads per batch, host-clock seconds per round from its
    submit to its fetched result with batch r-1's finish in between (round
    0 finishes nothing and round n-1 chains nothing, so rounds 1..n-2 are
    the steady state), and
    per round the seconds of its parts on the lane: "fetch_wait" the fetch
    up to `early_chain`, "seg_dispatch", "fetch_mid" from `early_chain` to
    `chain`, "seg_wait", "dispatch", "fetch_tail" after `chain`)."""
    lane = ThreadPoolExecutor(max_workers=1)
    holder, parts = {}, []

    def mark(name):
        now = time.perf_counter()
        parts[-1][name] = now - holder["t"]
        holder["t"] = now

    def early(r):
        mark("fetch_wait")
        checked(r, True)
        holder["segs"] = seg_dispatch(r + 1)
        mark("seg_dispatch")

    def chain(r):
        mark("fetch_mid")
        checked(r, False)
        segs = holder.pop("segs")()
        mark("seg_wait")
        checked(r, True)
        holder["next"] = dispatch(r + 1, segs)
        checked(r, False)
        mark("dispatch")

    def first():
        checked(-1, True)
        wait = seg_dispatch(0)
        checked(-1, False)
        segs = wait()
        checked(-1, True)
        fetch = dispatch(0, segs)
        checked(-1, False)
        return fetch

    def run(fetch, r, more):
        parts.append({})
        holder["t"] = time.perf_counter()
        got = fetch(functools.partial(chain, r) if more else None,
                    functools.partial(early, r) if more else None)
        mark("fetch_tail")
        return got

    try:
        fetch = lane.submit(first).result()
        out, times, prev = [], [], None
        for r in range(n):
            t0 = time.perf_counter()
            fut = lane.submit(run, fetch, r, r + 1 < n)
            if prev is not None:
                out.append(finish(r - 1, prev))
            prev = fut.result()
            fetch = holder.pop("next", None)
            times.append(time.perf_counter() - t0)
        out.append(finish(n - 1, prev))
    finally:
        lane.shutdown()
    return out, times, parts


def decode_lane(n, dispatch, fetch, checked=_unchecked):
    """Batches 0..n-1 through dispatch(i) -> handle on the lane and
    fetch(i, handle) -> output on the caller's thread, which fetches batch
    i while the lane dispatches batch i+1; checked(i, on) brackets
    dispatch(i).  Returns (outputs, host-clock seconds per round: from
    waiting for batch i's handle to its fetched output, where rounds
    1..n-2 overlap the next dispatch, and seconds of each dispatch(i) on
    the lane)."""
    lane = ThreadPoolExecutor(max_workers=1)
    spent = [0.0] * n

    def job(i):
        checked(i, True)
        t0 = time.perf_counter()
        try:
            return dispatch(i)
        finally:
            spent[i] = time.perf_counter() - t0
            checked(i, False)

    try:
        fut, out, times = lane.submit(job, 0), [], []
        for i in range(n):
            t0 = time.perf_counter()
            handle = fut.result()
            if i + 1 < n:
                fut = lane.submit(job, i + 1)
            out.append(fetch(i, handle))
            times.append(time.perf_counter() - t0)
    finally:
        lane.shutdown()
    return out, times, spent

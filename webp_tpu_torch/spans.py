"""Host-clock spans at the port's stage boundaries, kept in memory.

A caller that wants to see where a pipeline's host time goes switches
tracing on with `start()` and collects what was recorded with `stop()`:

    spans.start()
    ...                       # encode, decode
    for s in spans.stop():    # Span(name, thread, parent, t0, t1, counts)
        ...

The port opens `span(name)` around each stage (`enc.*`, `dec.*`,
`build.load`) and wraps each host pool task in `task(fn)`, so that the
task's span (`<submitter's span>.task`) has the span that submitted it as
its parent although it runs on another thread.  Times are
`time.perf_counter()`, the clock a caller's own spans would use.

Off (the default, and after `stop()`), `span()` returns one shared object
that does nothing and `task(fn)` returns `fn`: one check of a module
global, no clock read, no lock and no span object.  `torch.profiler`'s
`record_function` is not used: a range opened on a pool thread does not
reach the profiler's chrome trace unless the profiler records every
thread, and the call costs ~10 us with no profiler running.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple


class Span(NamedTuple):
    """One recorded span: `parent` is the index in `stop()`'s list of the
    span open on the same thread when it started (for a `task`, the span
    that submitted it), or -1; `counts` the integers given to it."""
    name: str
    thread: str
    parent: int
    t0: float
    t1: float
    counts: dict


class _Off:
    """The span handed out while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counts) -> None:
        pass


_OFF = _Off()
_spans = None  # the fields of the spans that ended since start(), or None: off
_seq = itertools.count()  # the spans' sequence numbers, for their children
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """An open span.  It lives only while open: on close its fields go onto
    the flat list of strings, floats and ints that `stop()` reads
    (sequence number, name, thread, the parent's sequence number, t0, t1,
    the number of counts, then each count's name and value), none of which
    the garbage collector tracks: a window's thousands of spans neither
    start its passes nor lengthen them."""

    __slots__ = ("name", "seq", "parent", "t0", "counts")

    def __init__(self, name: str, counts: dict, parent: int = None):
        self.name, self.counts, self.parent = name, counts, parent

    def __enter__(self):
        stack = _stack()
        if self.parent is None:
            self.parent = stack[-1].seq if stack else -1
        self.seq = next(_seq)
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        _stack().pop()
        recorded = _spans
        if recorded is not None:  # list.extend of a tuple is atomic: no lock
            recorded.extend((self.seq, self.name, threading.current_thread().name, self.parent,
                             self.t0, t1, len(self.counts), *itertools.chain(*self.counts.items())))
        return False

    def count(self, **counts) -> None:
        """Add integer counts to the span (relaunches, whether nvcc ran)."""
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + int(v)


def span(name: str, **counts):
    """A context manager timing the block as the span `name` (with the
    integer `counts`; `.count(**counts)` adds more), or the shared no-op
    while tracing is off."""
    if _spans is None:
        return _OFF
    return _Open(name, counts)


def task(fn):
    """`fn` for a pool worker: each call runs inside a span named after the
    caller's innermost open span plus ".task", whose parent is that span.
    `fn` itself while tracing is off."""
    if _spans is None:
        return fn
    stack = _stack()
    parent, name = (stack[-1].seq, stack[-1].name + ".task") if stack else (-1, ".task")

    def run(*args, **kwargs):
        with _Open(name, {}, parent):
            return fn(*args, **kwargs)

    return run


def start() -> None:
    """Switch tracing on, with nothing recorded yet."""
    global _spans
    _spans = []


def stop() -> list:
    """Switch tracing off and return the spans that ended since `start()`,
    by start time, as `Span`s ([] when it was off)."""
    global _spans
    recorded, _spans = _spans, None
    records, at = [], 0
    while recorded and at < len(recorded):
        end = at + 7 + 2 * recorded[at + 6]
        records.append(recorded[at:end])
        at = end
    records.sort(key=lambda r: r[4])
    index = {r[0]: i for i, r in enumerate(records)}
    return [Span(r[1], r[2], index.get(r[3], -1), r[4], r[5], dict(zip(r[7::2], r[8::2])))
            for r in records]

"""What a run measured, as the metric readers (`metrics/*.py`) read it."""

from __future__ import annotations

import statistics


def median(values):
    return statistics.median(values) if values else None


def percentile(values, q: int):
    """The q-th percentile (1..99) of the values, interpolated between the
    nearest ranks; None for fewer than two."""
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


class Readings:
    """One run's window [t_open, t_open + seconds] on the host clock, the
    loop's log (per batch handed, done and its size; the spans), set-up,
    and in a traced run the trace's summary and the work the window's
    images need (`roofline`)."""

    def __init__(self, seconds: float, t_open: float, log, sizes: dict, setup_s: float,
                 trace=None, work=None):
        self.seconds = seconds
        self.t_open = t_open
        self.t_close = t_open + seconds
        self.log = log
        self.sizes = sizes
        self.setup_s = setup_s
        self.trace = trace
        self.work = work  # (operations, bytes) of the window's images
        self.work_per_input = None  # {pool index: (operations, bytes)}

    def batches_done(self) -> list:
        """The batches whose results came back inside the window."""
        return sorted(i for i, t in self.log.done.items() if self.t_open < t <= self.t_close)

    def images_done(self) -> int:
        return sum(self.sizes[i] for i in self.batches_done())

    def slices(self, width: float = 5.0) -> list:
        """Images back in each `width`-second slice of the window, in order:
        how the rate moved inside the run."""
        n = max(1, int(self.seconds // width))
        counts = [0] * n
        for i in self.batches_done():
            counts[min(n - 1, int((self.log.done[i] - self.t_open) // width))] += self.sizes[i]
        return counts

    def latencies_ms(self) -> list:
        """Per batch done in the window, from its hand-over to the lane to
        its results, in ms."""
        return [(self.log.done[i] - self.log.handed[i]) * 1e3 for i in self.batches_done()]

    def span_ms(self, thread: str, name: str) -> list:
        """The durations in ms of one kind of span that lie inside the window."""
        return [(s.t1 - s.t0) * 1e3 for s in self.log.spans
                if s.thread == thread and s.name == name
                and s.t0 >= self.t_open and s.t1 <= self.t_close]


def roofline_pct(r: Readings):
    """The least time of the window's work (`roofline.least_seconds`) over
    the window's kernel time, in %; None without a trace or a work count."""
    from .roofline import least_seconds

    if r.trace is None or r.work is None or r.trace.kernel_s <= 0:
        return None
    return 100.0 * least_seconds(*r.work) / r.trace.kernel_s


def idle_pct(r: Readings):
    """The share of the traced window with no kernel, copy or set running, in %."""
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)


def rate(r: Readings):
    """Images whose results came back in the window, a second of it."""
    n = r.images_done()
    return n / r.seconds if n else None

"""The device trace of a run: `torch.profiler` (CUPTI) over the loop, reduced
to the window's busy time, kernel time, device operations and idle gaps.

The profiler records CPU and CUDA activity; `mark` puts a named user
annotation on the host's timeline, which ties the host clock of the
harness's spans to the trace's clock.  Nothing here runs without a trace.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from typing import NamedTuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Summary(NamedTuple):
    """The window's device time, in seconds: `busy_s` with any kernel, copy
    or set running, `kernel_s` with a kernel running, `window_s` the
    window's length; `device_ops` [[name, seconds]] the ten device
    operations with the most time, `idle_gaps` [[what the host was
    doing, seconds]] the idle time by the harness spans open across it."""
    busy_s: float
    kernel_s: float
    window_s: float
    device_ops: list
    idle_gaps: list


class Tracer:
    """A profiler over the loop when `enabled`, else nothing."""

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled = enabled
        self.marks = {}
        self._prof = None
        if enabled:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            self._prof = profile(activities=acts)

    def __enter__(self):
        if self._prof is not None:
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
        return False

    def mark(self, name: str) -> None:
        """An annotation on the trace at this moment of the host clock."""
        if self._prof is None:
            return
        from torch.profiler import record_function

        with record_function("bench:" + name):
            self.marks[name] = time.perf_counter()

    def summary(self, t_open: float, seconds: float, spans) -> Summary:
        """The window [t_open, t_open + seconds] (host clock) of the trace,
        or None when the trace holds no device operation or no mark."""
        if self._prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return reduce(events, self.marks, t_open, seconds, spans)


def _union(intervals):
    """Sorted, merged [start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _short(name: str) -> str:
    """A kernel's name without its return type, namespaces' noise, template
    and argument lists."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.startswith("void "):
        name = name[len("void "):]
    for sep in ("(", "<"):
        name = name.split(sep)[0]
    return name.strip()[:96] or "?"


def reduce(events, marks: dict, t_open: float, seconds: float, spans) -> Summary:
    """`Summary` of chrome-trace events: the host clock maps onto the trace
    by the marks (the mean offset of their annotations' midpoints)."""
    offsets = []
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and name.startswith("bench:"):
            t = marks.get(name[len("bench:"):])
            if t is not None:
                offsets.append(float(e["ts"]) + float(e.get("dur", 0)) / 2 - t * 1e6)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "ts" in e]
    if not offsets or not dev:
        return None
    off = sum(offsets) / len(offsets)
    w0 = t_open * 1e6 + off
    w1 = w0 + seconds * 1e6

    def clip(e):
        a = float(e["ts"])
        return max(a, w0), min(a + float(e.get("dur", 0)), w1)

    busy = _union([c for c in map(clip, dev) if c[1] > c[0]])
    kern = _union([c for e in dev if e["cat"] == "kernel" for c in [clip(e)] if c[1] > c[0]])
    by_name = {}
    for e in dev:
        a, b = clip(e)
        if b > a:
            n = _short(e.get("name", "")) if e["cat"] == "kernel" else e["cat"]
            by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
    gaps, at = [], w0
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < w1:
        gaps.append((at, w1))
    threads = {}
    for s in sorted(spans, key=lambda s: s.t0):
        threads.setdefault(s.thread, []).append((s.t0 * 1e6 + off, s.t1 * 1e6 + off, s.name))
    starts = {th: [x[0] for x in v] for th, v in threads.items()}
    idle = {}
    for a, b in gaps:
        mid = (a + b) / 2
        doing = []
        for th in sorted(threads):
            k = bisect.bisect_right(starts[th], mid) - 1
            if k >= 0 and threads[th][k][1] > mid:
                doing.append(f"{th}:{threads[th][k][2]}")
        label = "+".join(doing) or "host:between spans"
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return Summary(sum(b - a for a, b in busy) / 1e6, sum(b - a for a, b in kern) / 1e6,
                   seconds, top(by_name), top(idle))

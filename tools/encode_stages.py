#!/usr/bin/env python3
"""Where a pipelined batch loop's host time goes, from the port's own spans
(`webp_tpu_torch/spans.py`), on one NVIDIA GPU.

    python3 tools/encode_stages.py --seeds 3300000011,3300000012 [--seconds 51]
        [--workload kodak-q75-m4-devtok.encode] [--modes off,spans,trace] [--out FILE]

Runs a cell of the port's benchmark (`bench_port/`, its harness as it is)
once per seed and mode, all in one process, the modes in turn for each
seed: "off" is the benchmark's `--trace 0` run, "spans" the same run with
the port's spans recorded, "trace" the benchmark's `--trace 1` run (its
`torch.profiler` trace) with the spans recorded too.  `--workload` takes
the cells of `BENCHMARK.json` and those `bench_port/later.json` keeps for
later: `kodak-q75-m4-devtok.encode` (device tokens), `kodak-q75-m4.encode`
(the host finisher) and `kodak-q75-m4.decode`.  Per run it reports the
rate, set-up, the check, the medians of the lane's parts (the harness's
spans) and of each port stage over the window, and with spans:

- each lane part's split (`PARTS`, by the cell's route): per round, the
  stage spans that the part's span contains, the share of the part they
  cover (median and least over the rounds), and the five slowest rounds
  with the stage that grew most over its median and the interpreter's
  garbage-collection pauses inside the round;
- the window's collection pauses by generation (`gc.callbacks`);
- the port's `XFER` up and down over the window an image and
  `_build.LAUNCHES` over the window a batch (the counters read when the
  window opens and when it closes);
- before the first run, `build.load` (the kernel library's build and
  binding, and whether nvcc ran), once a process, under the spans;
- with "trace", the idle gaps of the device trace labelled as the
  harness labels them, then "::" and the innermost port span open at the
  gap's midpoint on each thread (`label_gaps`).

The per-round split, the window's counters and the gap labels are what a
benchmark PR would move into the harness (`harness/readings.py`,
`harness/trace.py`) to read them as per-layer metrics; this tool then
keeps only its runs.  Until then it wraps two of the harness's names for
the run (`Window` in the runner's module, `trace.reduce`).

Before the first run it times a span's open and close with tracing off
and on (`span_cost_us`); before each run, the benchmark's fixed
single-thread Python loop (`host_probe_ms`: the host's own speed).  One
JSON object a run goes to standard output and, with --out, all of them
to that file as one JSON list.  Without a card it exits 2.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import json
import statistics
import sys
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = ROOT / "bench_port"

_SEG = {("lane", "seg_wait"): ("enc.alphas_wait", "enc.kmeans"),
        ("lane", "seg_dispatch"): ("enc.colour", "enc.seg_dispatch")}
# (thread, lane part) -> the port's stage spans that run inside it, by route.
PARTS = {
    "device_tokens": {
        ("lane", "fetch_tail"): ("enc.k13_wait", "enc.token_fetch", "enc.header_coders",
                                 "enc.k14"),
        **_SEG},
    "host_finish": {("lane", "fetch_tail"): ("enc.wire_fetch",), **_SEG,
                    ("main", "finish"): ("enc.finish",)},
    "decode": {("lane", "dispatch"): ("dec.parse", "dec.upload", "dec.launch")},
}
MODES = ("off", "spans", "trace")


def route(cell) -> str:
    """The cell's route: "decode", "device_tokens" or "host_finish"."""
    if cell.traffic["runner"] == "decode_pipeline":
        return "decode"
    return "device_tokens" if cell.config["device_tokens"] else "host_finish"


def _median(values):
    return statistics.median(values) if values else None


def in_window(spans, t_open: float, t_close: float):
    return [s for s in spans if s.t0 >= t_open and s.t1 <= t_close]


def stage_ms(prog, name: str) -> list:
    """The durations in ms of the port spans called `name`."""
    return [(s.t1 - s.t0) * 1e3 for s in prog if s.name == name]


def split(lane_spans, prog, thread: str, part: str, stages) -> list:
    """Per round, (batch, the lane part's ms, {stage: ms of the stage spans
    that the part's span contains}); a stage span belongs to the round
    whose part on `thread` contains it, on the host clock."""
    rows = []
    inner = sorted((s for s in prog if s.name in stages), key=lambda s: s.t0)
    starts = [s.t0 for s in inner]
    for p in lane_spans:
        if p.thread != thread or p.name != part:
            continue
        got = dict.fromkeys(stages, 0.0)
        for s in inner[bisect.bisect_left(starts, p.t0):bisect.bisect_right(starts, p.t1)]:
            if s.t1 <= p.t1:
                got[s.name] += (s.t1 - s.t0) * 1e3
        rows.append((p.batch, (p.t1 - p.t0) * 1e3, got))
    return rows


def coverage(rows) -> dict:
    """The share of the part that its stage spans cover, over the rounds."""
    shares = [sum(got.values()) / ms for _, ms, got in rows if ms > 0]
    return {"median": _median(shares), "least": min(shares) if shares else None,
            "rounds": len(shares)}


def slowest(rows, k: int = 5) -> list:
    """The k rounds with the longest part: for each, the stage (or "other",
    the part's time no stage span covers) that lay farthest above its
    median over the rounds."""
    if not rows:
        return []
    full = [(b, ms, {**got, "other": ms - sum(got.values())}) for b, ms, got in rows]
    med = {n: _median([got[n] for _, _, got in full]) for n in full[0][2]}
    out = []
    for b, ms, got in sorted(full, key=lambda r: -r[1])[:k]:
        grew = max(got, key=lambda n: got[n] - med[n])
        out.append({"batch": b, "ms": ms, "stage": grew, "stage_ms": got[grew],
                    "stage_median_ms": med[grew]})
    return out


def pause_ms(pauses, t0: float, t1: float) -> float:
    """The ms of the collection pauses (generation, t0, t1) inside [t0, t1]."""
    return sum(min(b, t1) - max(a, t0) for _, a, b in pauses if b > t0 and a < t1) * 1e3


def pause_summary(pauses) -> dict:
    """Per generation: the pauses' count, total and longest, in ms."""
    out = {}
    for g, a, b in pauses:
        d = out.setdefault(f"gen{g}", {"n": 0, "ms": 0.0, "max_ms": 0.0})
        d["n"] += 1
        d["ms"] += (b - a) * 1e3
        d["max_ms"] = max(d["max_ms"], (b - a) * 1e3)
    return out


class GcPauses:
    """The interpreter's garbage-collection pauses (generation, t0, t1) on
    the host clock while inside the `with`."""

    def __init__(self):
        self.pauses, self._t0 = [], None

    def _callback(self, phase, info):
        now = time.perf_counter()
        if phase == "start":
            self._t0 = now
        elif self._t0 is not None:
            self.pauses.append((info["generation"], self._t0, now))
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)
        return False


def span_cost_us(n: int = 200_000) -> dict:
    """The mean µs of one `with spans.span(...)` with tracing off and on."""
    from webp_tpu_torch import spans

    def loop():
        t0 = time.perf_counter()
        for _ in range(n):
            with spans.span("enc.cost"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    off = loop()
    spans.start()
    try:
        on = loop()
    finally:
        spans.stop()
    return {"off": off, "on": on}


class _Segment(NamedTuple):
    """Where some thread's innermost open port span is `name`, as a harness
    span for `trace.reduce`, on the thread "::<name>"."""
    thread: str
    name: str
    t0: float
    t1: float


def innermost(prog) -> list:
    """The stretches of time in which some thread's innermost open port
    span is `name`, merged over the threads, as `_Segment`s."""
    from harness.trace import _union

    by_thread = {}
    for i, s in enumerate(prog):
        by_thread.setdefault(s.thread, []).extend([(s.t0, 1, i), (s.t1, 0, i)])
    by_name = {}
    for edges in by_thread.values():
        stack, at = [], None
        for t, opens, i in sorted(edges):
            if stack and t > at:
                by_name.setdefault(prog[stack[-1]].name, []).append((at, t))
            if opens:
                stack.append(i)
            else:
                stack.remove(i)
            at = t
    out = []
    for name, stretches in by_name.items():
        for a, b in _union(stretches):
            out.append(_Segment("::" + name, name, a, b))
    return out


def label_gaps(events, marks: dict, t_open: float, seconds: float, lane_spans, prog) -> list:
    """[[label, seconds]] of the window's idle gaps, largest first: the
    label `harness/trace.reduce` gives the gap (the harness spans open at
    its midpoint), then, where a port span is open there, "::" and the
    innermost port span open at the midpoint on each thread (names sorted,
    each once, joined by "+").  `reduce` itself finds the gaps, given the
    port's `innermost` segments beside the harness's spans, and keeps its
    ten largest labels; grouped by the text before "::", their seconds are
    its own."""
    from harness.trace import reduce

    summary = reduce(events, marks, t_open, seconds, list(lane_spans) + innermost(prog))
    if summary is None:
        return []
    labels = {}
    for label, secs in summary.idle_gaps:
        parts = label.split("+")
        harness = [p for p in parts if not p.startswith("::")]
        port = [p[2:].split(":", 1)[0] for p in parts if p.startswith("::")]
        label = "+".join(harness) or "host:between spans"
        if port:
            label += "::" + "+".join(port)
        labels[label] = labels.get(label, 0.0) + secs
    return [[k, v] for k, v in sorted(labels.items(), key=lambda kv: -kv[1])]


def _counters(rt: str):
    from webp_tpu_torch import _build
    from webp_tpu_torch.decode import device as ddev
    from webp_tpu_torch.encode import device as edev

    xfer = ddev.XFER if rt == "decode" else edev.XFER
    return {"up": xfer["up"], "down": xfer["down"], "launches": dict(_build.LAUNCHES)}


def _counting_window(base, rt: str):
    """`harness.loop.Window` that reads the port's counters when the window
    opens and when it closes, with the round about to be dispatched."""

    class CountingWindow(base):
        reads = {}

        def more(self, i):
            opened, closed = self.t_open is not None, self.closed
            go = base.more(self, i)
            if not opened and self.t_open is not None:
                CountingWindow.reads["open"] = (i, _counters(rt))
            if not closed and self.closed:
                CountingWindow.reads["close"] = (i, _counters(rt))
            return go

    return CountingWindow


def window_counts(reads: dict, batch: int) -> dict:
    """XFER's up and down bytes an image (KB) and the launches a batch
    between the window's two readings; each round in between fetches one
    batch."""
    if "open" not in reads or "close" not in reads:
        return {}
    (i0, c0), (i1, c1) = reads["open"], reads["close"]
    rounds = i1 - i0
    if rounds <= 0:
        return {}
    launches = {k: c1["launches"][k] - c0["launches"][k] for k in c1["launches"]}
    return {"rounds": rounds,
            "h2d_kb_img": (c1["up"] - c0["up"]) / 1e3 / (rounds * batch),
            "d2h_kb_img": (c1["down"] - c0["down"]) / 1e3 / (rounds * batch),
            "launches_batch": sum(launches.values()) / rounds,
            "launches": {k: v for k, v in launches.items() if v}}


def measure(cell, seed: int, seconds: float, mode: str, device: str, t_start: float,
            log=lambda line: None) -> dict:
    """One run of `cell` in `mode` ("off", "spans" or "trace")."""
    from harness import readings as rd, spec, trace as trace_mod
    from webp_tpu_torch import spans

    rt = route(cell)
    runner = spec.runner(cell.traffic)
    captured = {}
    reduce = trace_mod.reduce

    def keep(events, marks, t_open, secs, lane_spans):
        captured.update(events=events, marks=dict(marks))
        return reduce(events, marks, t_open, secs, lane_spans)

    window = runner.Window
    counting = _counting_window(window, rt)
    runner.Window, trace_mod.reduce = counting, keep
    try:
        if mode != "off":
            spans.start()
        with GcPauses() as collected:
            out = runner.run(cell, seed, seconds, mode == "trace", device, t_start, log=log)
    finally:
        prog = spans.stop()
        runner.Window, trace_mod.reduce = window, reduce
    r = out.readings
    lane = r.log.spans
    lane_w = in_window(lane, r.t_open, r.t_close)
    kinds = sorted({(p.thread, p.name) for p in lane_w})
    res = {"seed": seed, "mode": mode, "workload": cell.name, "img_s": rd.rate(r),
           "setup_s": r.setup_s, "slices": r.slices(5.0),
           "checks": {k: v for k, (v, _) in out.checks.items()}, "failed": out.failed,
           "attempted": out.attempted, "device": out.device,
           "lane_ms": {f"{th}:{n}": _median(r.span_ms(th, n)) for th, n in kinds}}
    res.update(window_counts(counting.reads, cell.traffic["batch"]))
    pauses = [p for p in collected.pauses if p[1] >= r.t_open and p[2] <= r.t_close]
    res["gc_pauses"] = pause_summary(pauses)
    if prog:
        inside = in_window(prog, r.t_open, r.t_close)
        names = sorted({s.name for s in inside})
        res["stage_ms"] = {n: _median(stage_ms(inside, n)) for n in names}
        res["stage_count"] = {n: len(stage_ms(inside, n)) for n in names}
        if res.get("rounds"):
            res["spans_a_round"] = sum(res["stage_count"].values()) / res["rounds"]
        res["k13_relaunches"] = sum(s.counts.get("relaunches", 0) for s in inside)
        at = {(p.thread, p.name, p.batch): p for p in lane_w}
        res["split"] = {}
        for (th, part), stages in PARTS[rt].items():
            rows = split(lane_w, inside, th, part, stages)
            worst = slowest(rows)
            for w in worst:
                p = at[(th, part, w["batch"])]
                w["gc_ms"] = pause_ms(pauses, p.t0, p.t1)
            res["split"][f"{th}:{part}"] = {
                "coverage": coverage(rows),
                "stage_ms": {n: _median([got[n] for _, _, got in rows]) for n in stages},
                "slowest": worst}
    if r.trace is not None:
        res["busy_s"], res["window_s"] = r.trace.busy_s, r.trace.window_s
        res["device_ops"] = r.trace.device_ops
        res["idle_gaps"] = r.trace.idle_gaps
        if captured and prog:
            res["idle_gaps_by_stage"] = label_gaps(captured["events"], captured["marks"],
                                                   r.t_open, seconds, lane, prog)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--workload", default="kodak-q75-m4-devtok.encode")
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--out", help="a file for all the runs' results")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]
    import run as bench_run  # the benchmark's cache paths and its process start
    from bench_rehearsal import with_later
    from harness import spec
    from harness.loop import log_err
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    modes = args.modes.split(",")
    if not set(modes) <= set(MODES):
        ap.error(f"--modes takes {MODES}")
    cell = spec.resolve(with_later(spec.load()), args.workload)
    power = _power()
    from webp_tpu_torch import _build, spans

    spans.start()
    _build.load()
    load = spans.stop()
    results = [{"build_load_s": load[0].t1 - load[0].t0, "nvcc": load[0].counts["nvcc"],
                "span_cost_us": span_cost_us(), "power": power}]
    print(json.dumps(results[0]), flush=True)
    t_start = bench_run.T_START
    for seed in map(int, args.seeds.split(",")):
        for mode in modes:
            probe = bench_run.host_probe_ms()
            res = measure(cell, seed, args.seconds, mode, "cuda", t_start, log_err)
            res["power"], res["host_probe_ms"] = power, probe
            results.append(res)
            print(json.dumps(res), flush=True)
            t_start = time.perf_counter()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


def _power() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


if __name__ == "__main__":
    sys.exit(main())

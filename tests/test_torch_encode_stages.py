"""`tools/encode_stages.py` on the CPU: the idle-gap labels against the
benchmark's own (`bench_port/harness/trace.reduce`) on synthetic trace
events, and whole runs of the encode cell at the harness's tiny size
(`bench_port/bench_rehearsal.py`) in each mode."""

import gc
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO / "bench_port"), str(REPO / "tools")]

import encode_stages as es  # noqa: E402
from bench_rehearsal import BENCH, SEED, TINY  # noqa: E402
from harness import spec  # noqa: E402
from harness.lane import Span as Part  # noqa: E402
from harness.trace import reduce  # noqa: E402

from webp_tpu_torch import spans  # noqa: E402
from webp_tpu_torch.spans import Span  # noqa: E402

WORKLOAD = "kodak-q75-m4-devtok.encode"


def _kernel(t0, t1):
    return {"cat": "kernel", "name": "void k<1>(int)", "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6}


def test_gap_labels_extend_the_harness_labels():
    """Three gaps: one under two harness spans with port spans on three
    threads, one under a port span whose last child ended before it, one
    under no span at all.  Grouped by the text before "::", the seconds
    are the harness's."""
    events = [{"cat": "user_annotation", "name": "bench:open", "ts": 5e6, "dur": 2.0},
              _kernel(10.0, 10.1), _kernel(10.3, 10.4), _kernel(10.6, 10.8),
              _kernel(10.9, 11.0), {"cat": "cpu_op", "name": "aten::add", "ts": 10.1e6}]
    marks = {"open": 5.0}  # the trace's clock 1 us ahead of the host's
    lane = [Part("lane", "fetch_tail", 0, 10.05, 10.35), Part("main", "wait", 0, 10.0, 10.45),
            Part("lane", "seg_dispatch", 1, 10.35, 10.7)]
    port = [Span("enc.k13_wait", "lane-thread", -1, 10.06, 10.25, {}),
            Span("enc.assemble", "MainThread", -1, 10.15, 10.3, {}),
            Span("enc.assemble.task", "pool_0", 1, 10.16, 10.22, {}),
            Span("enc.colour", "lane-thread", -1, 10.36, 10.45, {}),
            Span("enc.seg_dispatch", "lane-thread", -1, 10.46, 10.69, {}),
            Span("enc.upload", "lane-thread", 4, 10.47, 10.48, {})]
    got = es.label_gaps(events, marks, 10.0, 1.0, lane, port)
    assert {k for k, _ in got} == {
        "lane:fetch_tail+main:wait::enc.assemble+enc.assemble.task+enc.k13_wait",
        "lane:seg_dispatch::enc.seg_dispatch", "host:between spans"}
    grouped = {}
    for label, s in got:
        grouped[label.split("::")[0]] = grouped.get(label.split("::")[0], 0.0) + s
    want = dict(reduce(events, marks, 10.0, 1.0, lane).idle_gaps)
    assert grouped.keys() == want.keys()
    for k in want:
        assert grouped[k] == pytest.approx(want[k], rel=1e-12)


def test_round_split_and_slowest_rounds():
    lane = [Part("lane", "fetch_tail", b, 10.0 * b, 10.0 * b + 4.0) for b in range(4)]
    port = []
    for b in range(4):
        wait = 3.0 if b == 2 else 1.0  # round 2's wait grew
        port += [Span("enc.k13_wait", "l", -1, 10.0 * b, 10.0 * b + wait, {}),
                 Span("enc.k14", "l", -1, 10.0 * b + 3.5, 10.0 * b + 3.9, {}),
                 Span("enc.k14", "l", -1, 10.0 * b + 3.9, 10.0 * b + 4.1, {})]  # crosses out
    rows = es.split(lane, port, "lane", "fetch_tail", ("enc.k13_wait", "enc.k14"))
    assert [(b, ms) for b, ms, _ in rows] == [(b, 4000.0) for b in range(4)]
    assert rows[2][2]["enc.k13_wait"] == pytest.approx(3000.0)
    assert rows[0][2]["enc.k14"] == pytest.approx(400.0)
    cov = es.coverage(rows)
    assert cov["rounds"] == 4 and cov["median"] == pytest.approx(0.35)
    assert cov["least"] == pytest.approx(0.35)
    rows[2] = (2, 6000.0, rows[2][2])  # round 2 the slowest, by its wait
    worst = es.slowest(rows, k=2)
    assert [(w["batch"], w["stage"]) for w in worst[:1]] == [(2, "enc.k13_wait")]
    assert worst[0]["stage_ms"] == pytest.approx(3000.0)
    assert worst[0]["stage_median_ms"] == pytest.approx(1000.0)


def test_collection_pauses_by_round_and_generation():
    pauses = [(0, 1.0, 1.5), (2, 2.0, 2.2), (2, 3.9, 4.3)]
    assert es.pause_ms(pauses, 1.2, 4.0) == pytest.approx(300 + 200 + 100)
    assert es.pause_ms(pauses, 5.0, 6.0) == 0
    got = es.pause_summary(pauses)
    assert got["gen0"] == {"n": 1, "ms": pytest.approx(500), "max_ms": pytest.approx(500)}
    assert got["gen2"]["n"] == 2 and got["gen2"]["max_ms"] == pytest.approx(400)
    with es.GcPauses() as g:
        gc.collect()
    assert [p[0] for p in g.pauses][-1] == 2 and all(a <= b for _, a, b in g.pauses)
    assert g._callback not in gc.callbacks


def test_span_cost_leaves_tracing_off():
    cost = es.span_cost_us(n=1000)
    assert cost["off"] > 0 and cost["on"] > 0
    assert spans.span("x") is spans.span("y") and spans.stop() == []


def test_innermost_segments_merge_threads():
    """A thread's nested spans give the innermost one's stretches; the same
    name on two threads merges into one stretch."""
    port = [Span("a", "t1", -1, 0.0, 10.0, {}), Span("b", "t1", 0, 2.0, 4.0, {}),
            Span("c", "t2", -1, 3.0, 6.0, {}), Span("c", "t3", -1, 5.0, 7.0, {})]
    got = sorted((g.thread, g.name, g.t0, g.t1) for g in es.innermost(port))
    assert got == [("::a", "a", 0.0, 2.0), ("::a", "a", 4.0, 10.0), ("::b", "b", 2.0, 4.0),
                   ("::c", "c", 3.0, 7.0)]


RUNS = [pytest.param(WORKLOAD, m, id=m) for m in es.MODES] + [
    pytest.param("kodak-q75-m4.encode", "spans", id="host_finish-spans"),
    pytest.param("kodak-q75-m4.decode", "spans", id="decode-spans")]
FETCH_TAIL = {"device_tokens": es.PARTS["device_tokens"][("lane", "fetch_tail")],
              "host_finish": ("enc.wire_fetch",), "decode": ("dec.parse", "dec.upload",
                                                              "dec.launch")}


@pytest.mark.parametrize("workload,mode", RUNS)
def test_tool_run_on_the_cpu(workload, mode, monkeypatch):
    """A tiny run of each cell the tool takes (`later.json`'s too): the check
    passes in every mode; "off" never starts the spans and reports no
    split; with spans every stage of the lane part the cell's route splits
    is counted once a round inside the window."""
    if mode == "off":
        def refuse():
            raise AssertionError("spans.start() in an untraced run")
        monkeypatch.setattr(spans, "start", refuse)
    cell = spec.resolve(BENCH, workload)
    config = {**cell.config, **TINY["config"]}
    if cell.traffic["runner"] == "encode_pipeline":
        config["method"] = 0
    cell = cell._replace(config=config, traffic={**cell.traffic, **TINY["traffic"]})
    rt = es.route(cell)
    res = es.measure(cell, SEED, 2.0, mode, "cpu", time.perf_counter())
    assert set(res["checks"].values()) == {0} and res["failed"] == 0
    assert res["rounds"] >= 1 and res["launches_batch"] == 0
    assert res["h2d_kb_img" if rt == "decode" else "d2h_kb_img"] > 0
    assert isinstance(res["gc_pauses"], dict)
    if mode == "off":
        assert "stage_ms" not in res and "split" not in res
        return
    counts = res["stage_count"]
    part = "lane:dispatch" if rt == "decode" else "lane:fetch_tail"
    for name in FETCH_TAIL[rt]:
        assert res["stage_ms"][name] > 0
        assert abs(counts[name] - res["rounds"]) <= 1  # once a round; the edges cut one
    tail = res["split"][part]
    assert tail["coverage"]["rounds"] >= 1 and 0 < tail["coverage"]["median"] <= 1
    assert res["k13_relaunches"] == 0
    assert res["spans_a_round"] >= (10 if rt == "device_tokens" else 4)
    assert all(w["gc_ms"] >= 0 for w in tail["slowest"])
    if rt == "host_finish":
        assert res["split"]["main:finish"]["stage_ms"]["enc.finish"] > 0
    if rt == "decode":
        assert counts["dec.entropy"] == counts["dec.narrow"] == 2 * counts["dec.parse"]

"""The port's spans (`webp_tpu_torch/spans.py`) on the CPU.

- Off: `span` is one shared no-op that reads no clock, `task(fn)` is
  `fn`, and `stop()` returns nothing.
- On: nested spans name their parents and carry their counts, kept in
  a form the garbage collector does not track; a pool
  task's span (`<stage>.task`) has the span that submitted it as its
  parent, on another thread.
- The two-pass encode, device tokens and host finish, at 32x32 (two
  batches) and at 256 MBs (one batch, with K8 and the k-means): each
  stage span once a batch, in the order of the fetch; every pool task
  under its stage; the payloads byte-equal with tracing on and off.
- A K13 relaunch is counted on `enc.k13_wait`; the decode's spans;
  `build.load` with its nvcc count.
"""

import gc
import threading

import pytest
import torch

from webp_tpu_torch import _build, spans
from webp_tpu_torch.decode import device as tdev
from webp_tpu_torch.encode import device as edev
from webp_tpu_torch.ops import token_ops

from synthetic_rgb import synthetic_frame

QUALITY = 75
METHOD = 0  # the stages do not depend on the method; m0 keeps the 256-MB case short

SEG = ["enc.seg_dispatch", "enc.alphas_wait", "enc.kmeans"]
FETCH = ["enc.stats_wait", "enc.probs", "enc.tables", "enc.pass2"]
TOKENS = ["enc.k13_launch", "enc.k13_wait", "enc.token_fetch", "enc.header_coders", "enc.k14",
          "enc.assemble"]
HOST = ["enc.wire_fetch", "enc.finish"]
POOLED = {"enc.colour", "enc.kmeans", "enc.probs", "enc.header_coders", "enc.assemble",
          "enc.finish"}


@pytest.fixture(autouse=True)
def tracing_off():
    spans.stop()
    yield
    spans.stop()


def test_off_span_is_the_shared_noop_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("the clock was read while tracing is off")

    monkeypatch.setattr(spans.time, "perf_counter", no_clock)
    first = spans.span("a")
    assert spans.span("b", n=1) is first
    with first as s:
        s.count(n=2)
    fn = lambda i: i  # noqa: E731
    assert spans.task(fn) is fn
    assert edev._pool_map(fn, range(3)) == [0, 1, 2]
    assert spans.stop() == []


def test_nesting_gives_parents_and_counts():
    spans.start()
    with spans.span("a"):
        with spans.span("b", n=2) as b:
            b.count(n=3, m=True)
        with spans.span("c"):
            pass
    got = spans.stop()
    assert [(s.name, s.parent) for s in got] == [("a", -1), ("b", 0), ("c", 0)]
    assert got[1].counts == {"n": 5, "m": 1} and got[0].counts == {}
    assert all(s.thread == threading.current_thread().name and s.t0 <= s.t1 for s in got)
    assert got[0].t0 <= got[1].t0 <= got[1].t1 <= got[2].t0 <= got[2].t1 <= got[0].t1
    assert spans.stop() == []  # nothing is recorded between runs


def test_recorded_spans_stay_out_of_the_collector():
    """A closed span is kept as strings, floats and ints on one list, which
    the collector does not track: a window's thousands of spans neither
    start its passes nor lengthen them."""
    spans.start()
    for i in range(1000):
        with spans.span("a"):
            with spans.span("b", n=i):
                pass
    recorded = list(spans._spans)
    got = spans.stop()
    assert not any(gc.is_tracked(x) for x in recorded)
    assert len(got) == 2000 and got[1].counts == {"n": 0} and got[1].parent == 0
    assert got[-1].counts == {"n": 999} and got[-2].name == "a" and got[-2].counts == {}


def test_pool_task_parent_is_the_submitter_on_another_thread():
    spans.start()
    with spans.span("outer"):
        with spans.span("p"):
            names = edev._pool_map(lambda i: threading.current_thread().name, range(4))
    got = spans.stop()
    p = [s.name for s in got].index("p")
    tasks = [s for s in got if s.name == "p.task"]
    assert len(tasks) == 4 and all(s.parent == p for s in tasks)
    assert {s.thread for s in tasks} == set(names)
    assert threading.current_thread().name not in names
    assert all(got[p].t0 <= s.t0 <= s.t1 <= got[p].t1 for s in tasks)


def _encode(frames, device_tokens):
    """One batch through the pipeline's calls, in the lane's order: the
    colour conversion, the segments' dispatch and finish, the dispatch,
    the fetch and the finish; the payloads."""
    h, w = frames[0].shape[:2]
    planes = edev.rgb_to_planes(frames)
    segs = edev.dispatch_seg_results(planes, QUALITY, device="cpu")
    fetch = edev.dispatch_frames_lossy_batch(planes, QUALITY, METHOD, True, True, device="cpu",
                                             device_tokens=device_tokens, num_partitions=1,
                                             seg_results=segs())
    arrays, probs, segs = fetch(lambda: None, lambda: None)
    if device_tokens:
        return edev.finish_frames_tokens(arrays, probs, QUALITY, w, h, segs)
    return edev.finish_frames_lossy_batch(arrays, probs, QUALITY, w, h, 1, segs)


@pytest.mark.parametrize("size,batches", [((32, 32), 2), ((256, 256), 1)],
                         ids=["32x32", "256_mbs"])
@pytest.mark.parametrize("device_tokens", [True, False], ids=["device_tokens", "host_finish"])
def test_encode_emits_each_stage_once_a_batch(size, batches, device_tokens):
    frames = [[synthetic_frame(*size, 2 * b + k) for k in (1, 2)] for b in range(batches)]
    spans.start()
    traced = [_encode(f, device_tokens) for f in frames]
    got = spans.stop()
    assert traced == [_encode(f, device_tokens) for f in frames]  # tracing changes no byte

    kmeans = size[0] * size[1] // 256 >= edev.MIN_MBS
    want = (["enc.colour"] + (SEG if kmeans else []) + ["enc.dispatch"] + FETCH
            + (TOKENS if device_tokens else HOST))
    assert [s.name for s in got if s.parent < 0] == want * batches
    for s in got:
        if s.name.endswith(".task"):
            parent = got[s.parent]
            assert parent.name in POOLED and s.name == parent.name + ".task"
            assert parent.t0 <= s.t0 <= s.t1 <= parent.t1
    tasks = [got[s.parent].name for s in got if s.name.endswith(".task")]
    assert {n: tasks.count(n) for n in set(tasks)} == {
        n: 2 * batches for n in POOLED if n in want}
    assert all(s.counts == ({"relaunches": 0} if s.name == "enc.k13_wait" else {}) for s in got)


def test_k13_relaunch_is_counted_on_its_wait(monkeypatch):
    frames = [synthetic_frame(32, 32, s) for s in (1, 2)]
    want = _encode(frames, True)
    monkeypatch.setattr(token_ops, "token_budget", lambda nmb, nparts: 16)
    spans.start()
    assert _encode(frames, True) == want
    waits = [s for s in spans.stop() if s.name == "enc.k13_wait"]
    assert [s.counts for s in waits] == [{"relaunches": 1}]


def test_decode_spans():
    frames = [synthetic_frame(32, 32, s) for s in (3, 4)]
    payloads = _encode(frames, False)
    want = tdev.dispatch_decode_batch(payloads, device="cpu")
    spans.start()
    got_rgb = tdev.dispatch_decode_batch(payloads, device="cpu")
    got = spans.stop()
    assert torch.equal(got_rgb, want)
    assert [s.name for s in got if s.parent < 0] == ["dec.parse", "dec.upload", "dec.launch"]
    tasks = [i for i, s in enumerate(got) if s.name == "dec.parse.task"]
    assert len(tasks) == 2 and all(got[got[i].parent].name == "dec.parse" for i in tasks)
    inner = sorted((got[s.parent].name, s.name) for s in got
                   if s.parent >= 0 and got[s.parent].name == "dec.parse.task")
    assert inner == [("dec.parse.task", "dec.entropy")] * 2 + [("dec.parse.task",
                                                               "dec.narrow")] * 2


class _FakeLib:
    """Entry points that take argtypes and restype, for `load` without nvcc."""

    def __getattr__(self, name):
        fn = type("Entry", (), {})()
        setattr(self, name, fn)
        return fn


@pytest.mark.parametrize("stale", [True, False], ids=["built", "loaded"])
def test_build_load_span_counts_whether_nvcc_ran(monkeypatch, stale):
    built = []
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_entries", {})
    monkeypatch.setattr(_build, "stale", lambda lib, sources: stale)
    monkeypatch.setattr(_build, "_build", lambda: built.append(1))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: _FakeLib())
    spans.start()
    lib = _build.load()
    assert _build.load() is lib  # loaded once: one span
    got = spans.stop()
    assert [(s.name, s.counts) for s in got] == [("build.load", {"nvcc": int(stale)})]
    assert built == ([1] if stale else [])

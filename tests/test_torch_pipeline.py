"""The pipelined batch API of the port on the CPU, against the JAX package
(run on the CPU as its own tests run it) and the port's blocking path.

- `compute_seg_results(device="cpu")` (K8's plain twin, then k-means) and
  `setup_segments` against the JAX package's host analysis
  (`compute_seg_results(device=False)`, `setup_segments`), on two seeded
  256x256 frames and one frame under 256 MBs;
- `bench.py`'s encode pipeline (`tests/pipeline_lane.py`: one lane for
  every dispatch, fetch and hook, the host finish on the caller's thread)
  over two alternating seeded batches of 72x40 frames at method 3, the JAX
  package's `analyze_frames_lossy_batch` + `fetch(chain, early_chain)`
  against the port's `dispatch_frames_lossy_batch`, two-pass and one-pass
  with the host finisher and two-pass with device tokens, and each batch
  against the port's serial `encode_frames_lossy_batch`;
- the order of the hooks against the launches and fetches;
- the `XFER` counters, against the JAX package's;
- `probe_stage_times`, `encode_frame_lossy` (against `encode_rgb`'s VP8
  chunk), `adapted_probs_for` and `rgb_to_yuv420_numpy` (against the JAX
  package's);
- the pipelined encode (with segments through `dispatch_seg_results`, the
  256-MB floor lowered) and decode in a process where neither jax nor the
  JAX package can be imported, against the serial path.

Tolerance: byte-equal payloads, exact segmentations, probabilities and
byte counts.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from webp_tpu.decode import device as jdec
from webp_tpu.encode import vp8 as jvp8
from webp_tpu.ops import yuv as jyuv
from webp_tpu_torch import _build
from webp_tpu_torch.decode import device as tdev
from webp_tpu_torch.encode import device as edev
from webp_tpu_torch.encode import vp8 as tvp8
from webp_tpu_torch.encode.quant import quality_to_quant_index
from webp_tpu_torch.ops import wire
from webp_tpu_torch.ops.yuv import rgb_to_yuv420_numpy

import webp_tpu_torch
from pipeline_lane import encode_lane
from synthetic_rgb import synthetic_frame

REPO = Path(__file__).resolve().parent.parent
W, H = 72, 40
MBW, MBH = (W + 15) // 16, (H + 15) // 16
QUALITY = 75
METHOD = 3
PARTS = 8
BATCH_SEEDS = ((1, 2), (3, 4))  # two batches of two distinct frames
ROUNDS = 3  # batches through the pipeline: A, B, A (a fill round, then two)
SMALL = (32, 16)  # frames of the hook-order and XFER tests


@pytest.fixture(scope="module")
def batches():
    return [[synthetic_frame(W, H, s) for s in seeds] for seeds in BATCH_SEEDS]


def _order(i):
    return i % len(BATCH_SEEDS)


@pytest.fixture(scope="module")
def jax_pipeline(batches):
    """two_pass -> (payloads per round, XFER) of the JAX package's
    pipeline, 8 partitions, host finisher."""
    cache = {}

    def get(two_pass):
        if two_pass not in cache:
            planes = [[jyuv.rgb_to_yuv420(r) for r in b] for b in batches]
            jvp8.XFER.update(up=0, down=0)
            payloads, _, _ = encode_lane(
                ROUNDS,
                lambda i, segs: jvp8.analyze_frames_lossy_batch(
                    planes[_order(i)], QUALITY, METHOD, MBW, MBH, two_pass, False,
                    device_tokens=False, seg_results=segs),
                lambda i: lambda: None,
                lambda i, fetched: jvp8.finish_frames_lossy_batch(
                    planes[_order(i)], fetched, QUALITY, METHOD, W, H, False, PARTS))
            cache[two_pass] = payloads, dict(jvp8.XFER)
        return cache[two_pass]

    return get


def port_pipeline(batches, two_pass, device_tokens=False):
    """(payloads per round, XFER) of the port's pipeline on the CPU."""
    planes = [edev.rgb_to_planes(b) for b in batches]

    def dispatch(i, segs):
        return edev.dispatch_frames_lossy_batch(planes[_order(i)], QUALITY, METHOD, two_pass,
                                                device="cpu", device_tokens=device_tokens,
                                                num_partitions=PARTS, seg_results=segs)

    def finish(i, fetched):
        arrays, probs, segs = fetched
        if device_tokens:
            return edev.finish_frames_tokens(arrays, probs, QUALITY, W, H, segs)
        return edev.finish_frames_lossy_batch(arrays, probs, QUALITY, W, H, PARTS, segs)

    edev.XFER.update(up=0, down=0)
    payloads, times, parts = encode_lane(ROUNDS, dispatch, lambda i: lambda: None, finish)
    assert len(times) == len(parts) == ROUNDS
    return payloads, dict(edev.XFER)


def serial(batches, two_pass, segments=False):
    return [webp_tpu_torch.encode_frames_lossy_batch(b, QUALITY, METHOD, two_pass, segments,
                                                     num_partitions=PARTS, device="cpu")
            for b in batches]


@pytest.fixture(scope="module")
def serial_payloads(batches):
    """two_pass -> the port's serial encode of each batch."""
    cache = {}

    def get(two_pass):
        if two_pass not in cache:
            cache[two_pass] = serial(batches, two_pass)
        return cache[two_pass]

    return get


# ---- segmentation --------------------------------------------------------


def _same_segmentation(got, want):
    enabled, update_map, segment_map, segments, tree_probs = want
    assert (got.enabled, got.update_map) == (enabled, update_map)
    np.testing.assert_array_equal(got.segment_map, segment_map)
    assert got.tree_probs == list(tree_probs)
    assert ([(s.quant_index, s.uv_ac_delta, s.lf_level) for s in got.segments]
            == [(s.quant_index, s.uv_ac_delta, s.lf_level) for s in segments])


@pytest.mark.parametrize("size,seeds", [((256, 256), (11, 12)), ((128, 96), (13,))],
                         ids=["256_mbs", "under_256_mbs"])
def test_seg_results_match_jax_host_analysis(size, seeds):
    frames = [synthetic_frame(*size, s) for s in seeds]
    mbw, mbh = size[0] // 16, size[1] // 16
    qi = quality_to_quant_index(QUALITY)
    jplanes = [jyuv.rgb_to_yuv420(f) for f in frames]
    want = jvp8.compute_seg_results(jplanes, QUALITY, mbw, mbh, device=False)
    got = edev.compute_seg_results(edev.rgb_to_planes(frames), QUALITY, device="cpu")
    if mbw * mbh < 256:
        assert got is None  # segments off, as `segment` gives
        assert all(not w[0] and not w[1] for w in want)
    else:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.enabled and len(set(g.segment_map.tolist())) >= 2
            _same_segmentation(g, w)
    for f, p in zip(frames, jplanes):
        planes = (q[0] for q in edev.rgb_to_planes([f]))
        _same_segmentation(edev.setup_segments(*planes, qi, device="cpu"),
                           jvp8.setup_segments(*p, mbw, mbh, qi, jvp8.SegmentParams(qi)))


# ---- the pipeline ----------------------------------------------------------


@pytest.mark.parametrize("two_pass,device_tokens", [(True, False), (False, False), (True, True)],
                         ids=["two_pass", "one_pass", "device_tokens"])
def test_pipeline_matches_jax_pipeline(batches, jax_pipeline, serial_payloads, two_pass,
                                       device_tokens):
    """Every round's payloads equal the JAX package's pipeline's (host
    finisher, 8 partitions) and the port's serial encode of the batch; the
    XFER counters equal the JAX package's (up: the planes; down: the wire
    rows; the device-token flow's own fetches are checked below)."""
    want, jax_xfer = jax_pipeline(two_pass)
    got, xfer = port_pipeline(batches, two_pass, device_tokens)
    assert got == want
    assert [serial_payloads(two_pass)[_order(i)] for i in range(ROUNDS)] == got
    assert xfer["up"] == jax_xfer["up"] == ROUNDS * 2 * MBW * MBH * 384
    if not device_tokens:
        assert xfer["down"] == jax_xfer["down"] == ROUNDS * 2 * wire.wire_bytes(MBW * MBH)


@pytest.mark.parametrize("two_pass,device_tokens", [(True, False), (False, False), (True, True)],
                         ids=["two_pass", "one_pass", "device_tokens"])
def test_hooks_run_between_launches_and_fetch(monkeypatch, two_pass, device_tokens):
    """`early_chain` runs after the pass-1 statistics arrive and before pass
    2 is launched; `chain` after pass 2 (or K13) is launched and before
    the fetch; the one-pass fetch calls both before its fetch.  With
    device tokens K14 runs in the fetch, and the finisher only assembles
    (it refuses tokens without header lanes)."""
    log = []

    def record(name, fn):
        def wrapped(*a, **k):
            log.append(name)
            return fn(*a, **k)
        return wrapped

    for name, attr in (("K5", "encode_analysis_batch"), ("K5+wire", "encode_analysis_batch_packed"),
                       ("K13", "encode_tokens"), ("fetch", "fetch_packed"),
                       ("fetch", "fetch_tokens"), ("K14", "code_mb_headers")):
        monkeypatch.setattr(edev, attr, record(name, getattr(edev, attr)))
    download = _build.download
    monkeypatch.setattr(_build, "download", lambda t: record("stats", download(t)))
    fetch = edev.dispatch_frames_lossy_batch(edev.rgb_to_planes([synthetic_frame(*SMALL, 5)]),
                                             QUALITY, METHOD, two_pass, device="cpu",
                                             device_tokens=device_tokens)
    log.append("dispatched")
    tokens, probs, segs = fetch(lambda: log.append("chain"), lambda: log.append("early"))
    if not two_pass:
        assert log == ["K5+wire", "dispatched", "early", "chain", "fetch"]
    elif device_tokens:
        assert log == ["K5", "dispatched", "stats", "early", "K5", "K13", "chain", "fetch", "K14"]
        edev.finish_frames_tokens(tokens, probs, QUALITY, *SMALL, segs)
        assert len(log) == 9  # the finisher launched nothing
        with pytest.raises(ValueError):
            edev.finish_frames_tokens(tokens._replace(headers=None), probs, QUALITY, *SMALL, segs)
    else:
        assert log == ["K5", "dispatched", "stats", "early", "K5+wire", "chain", "fetch"]


def test_xfer_counts(serial_payloads):
    """Encode: up the planes' bytes, down the wire rows (two-pass and
    one-pass alike), and in the device-token flow what its fetches copy;
    decode: up the sparse route's arrays, as the JAX package counts them."""
    planes = edev.rgb_to_planes([synthetic_frame(*SMALL, s) for s in (5, 6)])
    nbytes = sum(p.nbytes for p in planes)
    nmb = (SMALL[0] // 16) * (SMALL[1] // 16)
    for two_pass in (True, False):
        edev.XFER.update(up=0, down=0)
        edev.analyze_frames_lossy_batch(planes, QUALITY, METHOD, two_pass, device="cpu")
        assert edev.XFER == {"up": nbytes, "down": 2 * wire.wire_bytes(nmb)}
    edev.XFER.update(up=0, down=0)
    tokens, _, _ = edev.analyze_frames_lossy_batch(planes, QUALITY, METHOD, device="cpu",
                                                   device_tokens=True, num_partitions=PARTS)
    assert edev.XFER == {"up": nbytes, "down": sum(
        a.nbytes for a in (tokens.meta, *tokens.parts, *tokens.headers))}

    payloads = serial_payloads(True)[0]
    assert tdev.parse_levels_batch(payloads)["bitmap"] is not None  # the sparse route
    tdev.XFER.update(up=0, down=0)
    tdev.dispatch_decode_batch(payloads, device="cpu")
    jbatch = jdec.parse_levels_batch(payloads)
    want = sum(int(jbatch[k].nbytes) for k in ("bitmap", "vals", "esc_pos", "esc_val", "qtab",
                                                 "u8buf"))
    assert tdev.XFER == {"up": want, "down": 0}


# ---- the thin counterparts ---------------------------------------------------


def test_probe_stage_times_on_cpu():
    times = edev.probe_stage_times(edev.rgb_to_planes([synthetic_frame(*SMALL, 5)]), QUALITY,
                                   METHOD, reps=1, device="cpu")
    assert set(times) == {"p1_s", "p2_s", "pack_s"}
    assert all(t > 0 for t in times.values())


def test_encode_frame_lossy_is_encode_rgb_vp8_chunk():
    """Two-pass, one partition, segments from 256 MBs, method 4: the VP8
    chunk of the encoder API's file."""
    rgb = synthetic_frame(*SMALL, 5)
    data = webp_tpu_torch.encode_rgb(rgb, 75, device="cpu")
    assert data[12:16] == b"VP8 "
    n = int.from_bytes(data[16:20], "little")
    assert edev.encode_frame_lossy(rgb, 75, device="cpu") == data[20:20 + n]


def test_adapted_probs_for_matches_jax(batches):
    arrays, _, _ = edev.analyze_frames_lossy_batch(edev.rgb_to_planes(batches[0][:1]), QUALITY,
                                                   METHOD, False, device="cpu")
    a = {k: np.asarray(v, np.int32) for k, v in arrays[0].items()}
    got = tvp8.adapted_probs_for(a, MBW, MBH)
    want = jvp8.adapted_probs_for({k: v.copy() for k, v in a.items()}, MBW, MBH)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (got != jvp8.T.COEFF_PROBS_DEFAULT).any()


@pytest.mark.parametrize("width,height,channels", [(72, 40, 3), (33, 17, 4), (1, 1, 3)])
def test_rgb_to_yuv420_numpy_matches_jax(width, height, channels):
    rgb = np.random.RandomState(width).randint(0, 256, (height, width, channels)).astype(np.uint8)
    for got, want in zip(rgb_to_yuv420_numpy(rgb), jyuv.rgb_to_yuv420_numpy(rgb)):
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_pipeline_runs_without_jax(tmp_path):
    """With jax and the JAX package unimportable, the pipelined encode (both
    flows, segments on through `dispatch_seg_results`, the 256-MB floor
    lowered to 0) and the pipelined decode of its payloads run on the CPU;
    they equal the serial encode and decode of this process."""
    size = (32, 32)
    script = textwrap.dedent(
        f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["webp_tpu"] = None
        sys.path[:0] = [{str(REPO)!r}, {str(REPO / "tests")!r}]
        import webp_tpu_torch
        from webp_tpu_torch.decode import device as tdev
        from webp_tpu_torch.encode import device as edev
        from pipeline_lane import decode_lane, encode_lane
        from synthetic_rgb import synthetic_frame
        edev.MIN_MBS = 0
        w, h = {size}
        batches = [[synthetic_frame(w, h, s) for s in seeds] for seeds in {BATCH_SEEDS}]
        planes = [edev.rgb_to_planes(b) for b in batches]
        for tokens in (False, True):
            def dispatch(i, segs):
                return edev.dispatch_frames_lossy_batch(
                    planes[i % 2], {QUALITY}, {METHOD}, True, True, device="cpu",
                    device_tokens=tokens, num_partitions={PARTS}, seg_results=segs)
            def finish(i, fetched):
                arrays, probs, segs = fetched
                assert all(s.enabled for s in segs)
                if tokens:
                    return edev.finish_frames_tokens(arrays, probs, {QUALITY}, w, h, segs)
                return edev.finish_frames_lossy_batch(arrays, probs, {QUALITY}, w, h, {PARTS},
                                                      segs)
            out, _, _ = encode_lane({ROUNDS}, dispatch, lambda i: edev.dispatch_seg_results(
                planes[i % 2], {QUALITY}, device="cpu"), finish)
            for i, p in enumerate(out):
                open(f"p{{int(tokens)}}{{i}}.bin", "wb").write(b"".join(
                    len(x).to_bytes(4, "little") + x for x in p))
        decoded, _, _ = decode_lane({ROUNDS}, lambda i: tdev.dispatch_decode_batch(out[i],
                                                                                   device="cpu"),
                                    lambda i, rgb: rgb.numpy())
        for i, d in enumerate(decoded):
            assert (d == webp_tpu_torch.decode_vp8_batch_device(out[i], device="cpu")).all(), i
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "webp_tpu")]
        assert all(sys.modules[m] is None for m in bad), bad
        print("NOJAX_OK")
        """
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          cwd=tmp_path, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NOJAX_OK" in proc.stdout
    old = edev.MIN_MBS
    edev.MIN_MBS = 0
    try:
        want = serial([[synthetic_frame(*size, s) for s in seeds] for seeds in BATCH_SEEDS], True,
                      segments=True)
    finally:
        edev.MIN_MBS = old
    for tokens in (0, 1):
        for i in range(ROUNDS):
            blob = (tmp_path / f"p{tokens}{i}.bin").read_bytes()
            got, at = [], 0
            while at < len(blob):
                n = int.from_bytes(blob[at:at + 4], "little")
                got.append(blob[at + 4:at + 4 + n])
                at += 4 + n
            assert got == want[_order(i)]

"""The encode slice on the CPU: `webp_tpu_torch.encode_frames_lossy_batch`
against the JAX package's `analyze_frames_lossy_batch` +
`finish_frames_lossy_batch` (run on the CPU as its own tests run it) at
method 3, two-pass on and off, 1 and 8 coefficient partitions, on seeded
synthetic 72x40 frames (partial MBs; `test_torch_encode_m1.py` has method
1, `test_torch_encode_m4.py` and `test_torch_encode_m6.py` methods 4-6 and
segments).  Also, with no JAX compile: the RGB->YUV420 conversion, the
mixed-geometry entry point, methods 4-6 and segments (on at 256 MBs, the
segment ids parsed back from the payload by the C++ entropy pass), the
payloads' round trip through the decoders, and the encode path (the
flagship, method 4 with segments, with the host finisher and with the
device token coder) in a process where neither jax nor the JAX package can
be imported.  The device token coder (`device_tokens=True`) at method 3
against the JAX package's host writer at 8 partitions.  Tolerance: byte-equal payloads, bit-exact
planes and segment ids.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from webp_tpu.encode import vp8 as jvp8
from webp_tpu.ops import yuv as jyuv
from webp_tpu_torch.decode import device as tdev
from webp_tpu_torch.encode import device as edev

import webp_tpu_torch
from synthetic_rgb import synthetic_frame
from torch_fixtures import scalar_decode

REPO = Path(__file__).resolve().parent.parent
W, H = 72, 40
QUALITY = 75
FLAGSHIP = 256  # frames of 16x16 MBs: segmentation on
ENC_SEEDS = (11, 12)  # chip_smoke.ENC_SEEDS


@pytest.fixture(scope="module")
def rgbs():
    return [synthetic_frame(W, H, s) for s in (1, 2)]


@pytest.fixture(scope="module")
def jax_fetched(rgbs):
    """(method, two_pass) -> (planes, fetched) of the JAX package's analysis."""
    cache = {}

    def get(method, two_pass):
        if (method, two_pass) not in cache:
            planes = [jyuv.rgb_to_yuv420(r) for r in rgbs]
            fetched = jvp8.analyze_frames_lossy_batch(
                planes, QUALITY, method, (W + 15) // 16, (H + 15) // 16, two_pass, False)()
            cache[(method, two_pass)] = planes, fetched
        return cache[(method, two_pass)]

    return get


def jax_encode(jax_fetched, method, two_pass, nparts):
    planes, fetched = jax_fetched(method, two_pass)
    return jvp8.finish_frames_lossy_batch(planes, fetched, QUALITY, method, W, H, False, nparts)


@pytest.mark.parametrize("nparts", [1, 8])
@pytest.mark.parametrize("two_pass", [True, False], ids=["two_pass", "one_pass"])
def test_encode_matches_jax_method3(rgbs, jax_fetched, two_pass, nparts):
    got = webp_tpu_torch.encode_frames_lossy_batch(rgbs, QUALITY, 3, two_pass,
                                                   num_partitions=nparts, device="cpu")
    want = jax_encode(jax_fetched, 3, two_pass, nparts)
    assert got == want


def test_device_tokens_match_jax_method3(rgbs, jax_fetched):
    want = jax_encode(jax_fetched, 3, True, 8)
    got = webp_tpu_torch.encode_frames_lossy_batch(rgbs, QUALITY, 3, num_partitions=8,
                                                   device_tokens=True, device="cpu")
    assert got == want
    assert webp_tpu_torch.encode_frames_lossy_batch_mixed(
        rgbs, QUALITY, 3, num_partitions=8, device_tokens=True, device="cpu") == want


def test_device_tokens_need_two_pass(rgbs):
    with pytest.raises(ValueError, match="two-pass"):
        webp_tpu_torch.encode_frames_lossy_batch(rgbs, QUALITY, 3, False, device_tokens=True,
                                                 device="cpu")
    with pytest.raises(ValueError, match="two-pass"):
        edev.analyze_frames_lossy_batch(edev.rgb_to_planes(rgbs), QUALITY, 3, False,
                                        device="cpu", device_tokens=True)


@pytest.mark.parametrize("width,height,channels", [(72, 40, 3), (33, 17, 4), (1, 1, 3)])
def test_rgb_to_planes_matches_jax_package(width, height, channels):
    rng = np.random.RandomState(width)
    rgbs = [rng.randint(0, 256, (height, width, channels)).astype(np.uint8) for _ in range(2)]
    got = edev.rgb_to_planes(rgbs)
    for i, r in enumerate(rgbs):
        for g, w in zip(got, jyuv.rgb_to_yuv420_numpy(r)):
            np.testing.assert_array_equal(g[i], w)


def test_mixed_geometries(rgbs, jax_fetched):
    other = [synthetic_frame(40, 24, 7)]
    got = webp_tpu_torch.encode_frames_lossy_batch_mixed(
        [rgbs[0], other[0], rgbs[1]], QUALITY, 3, device="cpu")
    want = jax_encode(jax_fetched, 3, True, 1)
    assert [got[0], got[2]] == want
    assert got[1] == webp_tpu_torch.encode_frames_lossy_batch(other, QUALITY, 3, device="cpu")[0]


@pytest.fixture(scope="module")
def flagship():
    """two_pass -> (frames, payloads, segmentations) of the port's Q75 m4
    segments-on 8-partition encode of chip_smoke's seeded frames at 256x256,
    through its stages."""
    cache = {}

    def get(two_pass):
        if two_pass not in cache:
            frames = [synthetic_frame(FLAGSHIP, FLAGSHIP, s) for s in ENC_SEEDS]
            arrays, probs, segs = edev.analyze_frames_lossy_batch(
                edev.rgb_to_planes(frames), QUALITY, 4, two_pass, True, device="cpu")
            cache[two_pass] = frames, edev.finish_frames_lossy_batch(
                arrays, probs, QUALITY, FLAGSHIP, FLAGSHIP, 8, segs), segs
        return cache[two_pass]

    return get


def _check_decodes(rgbs, payloads):
    """The port's decode of the payloads is the scalar decoder's, and close
    to the source."""
    decoded = webp_tpu_torch.decode_vp8_batch_device(payloads, device="cpu")
    for rgb, p, d in zip(rgbs, payloads, decoded):
        np.testing.assert_array_equal(d, scalar_decode(p)[0])
        mse = np.mean((d.astype(np.float64) - rgb) ** 2)
        assert 10 * np.log10(255 ** 2 / mse) > 25


@pytest.mark.parametrize("method", [4, 5, 6])
def test_trellis_methods_encode(rgbs, method):
    """Methods 4-6 (the trellis; n_try 4, 10, 10) run through both entry
    points and decode back."""
    payloads = webp_tpu_torch.encode_frames_lossy_batch(rgbs, QUALITY, method, device="cpu")
    assert webp_tpu_torch.encode_frames_lossy_batch_mixed(rgbs, QUALITY, method,
                                                          device="cpu") == payloads
    _check_decodes(rgbs, payloads)


@pytest.mark.parametrize("two_pass", [True, False], ids=["two_pass", "one_pass"])
def test_segments_encode(flagship, two_pass):
    """Segments on at 256 MBs: the header's segment map, parsed back by the
    C++ entropy pass, is the analysis' map (2+ ids used), and the payloads
    decode back."""
    frames, payloads, segs = flagship(two_pass)
    batch = tdev.parse_levels_batch(payloads)
    ids = tdev.field_views(batch["u8buf"], (FLAGSHIP // 16) ** 2)["segment_ids"]
    for i, s in enumerate(segs):
        assert s.enabled and s.update_map and len(set(s.segment_map.tolist())) >= 2
        np.testing.assert_array_equal(ids[i], s.segment_map)
        # The header's quantizer deltas parse back to each segment's y1 and uv steps.
        for k, x in enumerate(s.segments):
            ydc, yac, _, _, uvdc, uvac = batch["segs"][i, k, 2:8]
            assert (ydc, yac, uvdc, uvac) == (x.y1.q[0], x.y1.q[1], x.uv.q[0], x.uv.q[1])
    _check_decodes(frames, payloads)


def test_bad_arguments_raise(rgbs):
    with pytest.raises(ValueError):
        webp_tpu_torch.encode_frames_lossy_batch(rgbs, QUALITY, 3, num_partitions=3, device="cpu")
    with pytest.raises(ValueError):
        webp_tpu_torch.encode_frames_lossy_batch([rgbs[0], synthetic_frame(40, 24, 7)],
                                                 QUALITY, 3, device="cpu")


def test_payloads_round_trip_through_the_decoders(rgbs):
    """The port's decode of the port's payloads is the scalar decoder's, and
    close to the source."""
    _check_decodes(rgbs, webp_tpu_torch.encode_frames_lossy_batch(rgbs, QUALITY, 3,
                                                                  num_partitions=8, device="cpu"))


def test_encode_runs_without_jax(tmp_path, flagship):
    """With jax and the JAX package unimportable, the port encodes the
    flagship (method 4, segments on), with the host finisher and with the
    device token coder; the payloads equal those of this process."""
    script = textwrap.dedent(
        f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["webp_tpu"] = None
        sys.path[:0] = [{str(REPO)!r}, {str(REPO / "tests")!r}]
        import webp_tpu_torch
        from synthetic_rgb import synthetic_frame
        rgbs = [synthetic_frame({FLAGSHIP}, {FLAGSHIP}, s) for s in {ENC_SEEDS}]
        out = webp_tpu_torch.encode_frames_lossy_batch(rgbs, {QUALITY}, 4, True, True,
                                                       num_partitions=8, device="cpu")
        tokens = webp_tpu_torch.encode_frames_lossy_batch(rgbs, {QUALITY}, 4, True, True,
                                                          num_partitions=8, device="cpu",
                                                          device_tokens=True)
        assert tokens == out
        for i, p in enumerate(out):
            open(f"p{{i}}.bin", "wb").write(p)
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
    assert [(tmp_path / f"p{i}.bin").read_bytes() for i in range(2)] == flagship(True)[1]


def test_chip_smoke_encode_phases_on_cpu_without_jax(tmp_path, flagship):
    """chip_smoke's encode inputs, reference and checks, at small sizes (m3 at
    96x64; the flagship, m4 with segments, at 256x256), with jax and the JAX
    package unimportable; the references equal the port's encodes."""
    script = textwrap.dedent(
        f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["webp_tpu"] = None
        sys.path.insert(0, {str(REPO)!r})
        import chip_smoke
        assert chip_smoke.ENC_SEEDS == {ENC_SEEDS}
        for (method, segments), size in zip(chip_smoke.ENCODES, ((96, 64), ({FLAGSHIP}, {FLAGSHIP}))):
            distinct, batch = chip_smoke.encode_inputs(*size)
            assert len(batch) == chip_smoke.BATCH and batch[2] is distinct[0]
            ref = chip_smoke.encode_reference(distinct, method, segments)
            print("CHECK", method, chip_smoke.check_reference(ref, segments))
            for two_pass, (_, payloads, _) in ref.items():
                for i, p in enumerate(payloads):
                    open(f"p{{method}}{{int(two_pass)}}{{i}}.bin", "wb").write(p)
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "webp_tpu")]
        assert all(sys.modules[m] is None for m in bad), bad
        """
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          cwd=tmp_path, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "segment ids used" in proc.stdout.split("CHECK 4")[1]
    distinct = [synthetic_frame(96, 64, s) for s in ENC_SEEDS]
    for two_pass in (True, False):
        want = webp_tpu_torch.encode_frames_lossy_batch(distinct, QUALITY, 3, two_pass,
                                                        num_partitions=8, device="cpu")
        assert [(tmp_path / f"p3{int(two_pass)}{i}.bin").read_bytes() for i in range(2)] == want
        assert ([(tmp_path / f"p4{int(two_pass)}{i}.bin").read_bytes() for i in range(2)]
                == flagship(two_pass)[1])

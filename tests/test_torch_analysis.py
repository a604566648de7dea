"""The segment analysis on the CPU: kernel K8's plain twin
(`webp_tpu_torch/ops/analysis.py` `analyze_alphas_batch_plain`) against the
JAX package's `webp_tpu.ops.analysis2.analyze_alphas_batch` at 16x16 and
20x13 MBs (seeded synthetic and noise planes), and the host k-means
(`webp_tpu_torch/encode/analysis.py` `setup_segments_from_alphas`) against
`webp_tpu.encode.vp8.setup_segments_from_alphas`: segment map, each
segment's parameters, tree probabilities and the update-map flag.
Tolerance: bit-exact (integer arithmetic; the k-means' float steps are the
same Python expressions)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.encode import vp8 as jvp8
from webp_tpu.ops.analysis2 import analyze_alphas_batch as janalyze
from webp_tpu_torch.encode import device as edev
from webp_tpu_torch.encode.analysis import segments_off, setup_segments_from_alphas
from webp_tpu_torch.encode.quant import SegmentParams, quality_to_quant_index
from webp_tpu_torch.ops.analysis import analyze_alphas_batch, analyze_alphas_batch_plain

from synthetic_rgb import synthetic_frame

SEG_FIELDS = ("quant_index", "quantizer_level", "uv_ac_delta", "uv_dc_delta", "lf_level",
              "lambda_i4", "lambda_i16", "lambda_uv", "lambda_mode", "tlambda",
              "lambda_trellis_i4", "lambda_trellis_i16")


def _planes(mbw: int, mbh: int):
    """Two synthetic frames and one of seeded noise, as padded YUV420."""
    rgbs = [synthetic_frame(mbw * 16, mbh * 16, s) for s in (1, 2)]
    rgbs.append(np.random.RandomState(mbw).randint(0, 256, (mbh * 16, mbw * 16, 3), np.uint8))
    return edev.rgb_to_planes(rgbs)


@pytest.fixture(scope="module", params=[(16, 16), (20, 13)], ids=["16x16", "20x13"])
def alphas(request):
    mbw, mbh = request.param
    planes = _planes(mbw, mbh)
    got = analyze_alphas_batch(*edev.upload(planes, "cpu"))
    want = janalyze(*(jnp.asarray(p) for p in planes), mbw, mbh)
    return got, tuple(np.asarray(w) for w in want)


def test_alphas_match_jax(alphas):
    (final, uv), (want_final, want_uv) = alphas
    assert final.dtype == uv.dtype == torch.int32
    np.testing.assert_array_equal(final.numpy(), want_final)
    np.testing.assert_array_equal(uv.numpy(), want_uv)
    assert len(np.unique(final.numpy())) > 8  # a spread the k-means can split


def test_segments_match_jax(alphas):
    (final, uv), _ = alphas
    for quality in (30, 75, 95):
        qi = quality_to_quant_index(quality)
        for a, u in zip(final.numpy(), uv.numpy()):
            got = setup_segments_from_alphas(a, int(u), qi)
            enabled, update, seg_map, segs, probs = jvp8.setup_segments_from_alphas(a, int(u), qi)
            assert (got.enabled, got.update_map, got.tree_probs) == (enabled, update, probs)
            np.testing.assert_array_equal(got.segment_map, seg_map)
            assert got.segment_map.dtype == np.int32
            for s, j in zip(got.segments, segs):
                for f in SEG_FIELDS:
                    assert getattr(s, f) == getattr(j, f), f
                for m in ("y1", "y2", "uv"):
                    for attr in ("q", "iq", "bias", "sharpen"):
                        np.testing.assert_array_equal(getattr(getattr(s, m), attr),
                                                      getattr(getattr(j, m), attr))


def test_flat_frame_segments():
    """A flat frame: one alpha value, every MB in one segment, the tree
    probabilities all 255 and so no map update, as in the JAX package."""
    alphas = np.full(300, 17, np.int64)
    got = setup_segments_from_alphas(alphas, 40, 30)
    want = jvp8.setup_segments_from_alphas(alphas, 40, 30)
    assert (got.enabled, got.update_map, got.tree_probs) == (want[0], want[1], want[4])
    np.testing.assert_array_equal(got.segment_map, want[2])
    off = segments_off(300, SegmentParams(30))
    assert not off.enabled and not off.update_map and not off.segment_map.any()


def test_plain_twin_is_the_cpu_route():
    planes = edev.upload(_planes(16, 16), "cpu")
    for a, b in zip(analyze_alphas_batch(*planes), analyze_alphas_batch_plain(*planes)):
        assert torch.equal(a, b)

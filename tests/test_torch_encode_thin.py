"""Kernel K5's plain twin (`ops/encode_wavefront.py`) on frames one MB wide
and one MB high, against the JAX package's `encode_analysis_batch_v2` on
the CPU (at one MB column every other anti-diagonal t = x + 2y is empty).
Seeded synthetic frames, a batch of 2, n_try 3 without the trellis, with
per-image tables of seeded random probabilities.  Tolerance: bit-exact
(integer arithmetic)."""

import jax.numpy as jnp
import numpy as np
import pytest

from webp_tpu.encode import costs as JC
from webp_tpu.encode.quant import SegmentParams as JSegmentParams
from webp_tpu.ops.encode_wavefront import EncParams as JEncParams
from webp_tpu.ops.encode_wavefront import EncTables as JEncTables
from webp_tpu.ops.encode_wavefront2 import encode_analysis_batch_v2
from webp_tpu_torch.encode import device as edev
from webp_tpu_torch.encode.quant import SegmentParams, quality_to_quant_index
from webp_tpu_torch.ops.enc_params import EncParams, EncTables
from webp_tpu_torch.ops.encode_wavefront import encode_analysis_batch

from synthetic_rgb import synthetic_frame


@pytest.mark.parametrize("w,h", [(16, 96), (96, 16)], ids=["one_mb_column", "one_mb_row"])
def test_encode_analysis_thin_frames_match_jax(w, h):
    planes = edev.rgb_to_planes([synthetic_frame(w, h, s) for s in (3, 4)])
    qi = quality_to_quant_index(75)
    probs = np.random.RandomState(w).randint(1, 256, (2, 4, 8, 3, 11)).astype(np.uint8)
    got = encode_analysis_batch(*edev.upload(planes, "cpu"), EncParams.from_segment(SegmentParams(qi)),
                                EncTables.from_probs(probs), 3)
    jp = [jnp.asarray(p) for p in planes]
    for i in range(2):
        jt = JEncTables.from_level_costs(JC.LevelCosts(probs[i]))
        want = encode_analysis_batch_v2(*jp, JEncParams(JSegmentParams(qi)), jt, w // 16, h // 16, 3)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k][i].numpy(), np.asarray(v)[i], err_msg=k)
    assert (got["luma_mode"] == 4).any() and (got["luma_mode"] != 4).any()

"""Kernel K5's plain twin (`ops/encode_wavefront.py`) and its rate model
(`ops/enc_costs.py`) against the JAX package on the CPU: `residual_costs`
against `residual_costs_par` for every token type, first position and
context; `encode_analysis_batch` against `encode_analysis_batch_v2` on
seeded synthetic 72x40 frames (partial MBs), a batch of 2, n_try 0 and 3,
with the default tables and with per-image tables of seeded random
probabilities; and with seeded random segment ids over four segments of
different qualities per image (`EncParamsSegs`), at n_try 3 without the
trellis (pass 1) and at n_try 4 and 10 with it (pass 2 of methods 4-6).
Tolerance: bit-exact (integer arithmetic)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.encode import costs as JC
from webp_tpu.encode.quant import SegmentParams as JSegmentParams
from webp_tpu.ops.encode_wavefront import EncParams as JEncParams
from webp_tpu.ops.encode_wavefront import EncParamsSegs as JEncParamsSegs
from webp_tpu.ops.encode_wavefront import EncTables as JEncTables
from webp_tpu.ops.encode_wavefront import _rd_score32
from webp_tpu.ops.encode_wavefront2 import encode_analysis_batch_v2, residual_costs_par
from webp_tpu_torch.common import vp8_tables as T
from webp_tpu_torch.encode import device as edev
from webp_tpu_torch.encode.quant import SegmentParams, quality_to_quant_index
from webp_tpu_torch.ops.enc_costs import residual_costs
from webp_tpu_torch.ops.enc_params import EncParams, EncTables, rd_score32
from webp_tpu_torch.ops.encode_wavefront import encode_analysis_batch

from synthetic_rgb import synthetic_frame

W, H = 72, 40
MBW, MBH = 5, 3
QUALITY = 75


def _random_probs(seed: int, batch: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(1, 256, (batch, 4, 8, 3, 11)).astype(np.uint8)


@pytest.fixture(scope="module")
def tables_probs():
    return _random_probs(23, 1)[0]


@pytest.mark.parametrize("first", [0, 1])
@pytest.mark.parametrize("ctype", [0, 1, 2, 3])
def test_residual_costs_match_jax(ctype, first, tables_probs):
    rng = np.random.RandomState(ctype * 2 + first)
    mags = rng.choice([0, 0, 0, 0, 1, 1, 2, 3, 4, 5, 6, 7, 9, 10, 11, 19, 35, 66, 67, 68, 700,
                       2047], size=(96, 16))
    mags[rng.rand(96) < 0.2] = 0
    mags[rng.rand(96) < 0.2, 15] = 1           # blocks that end at position 15
    mags[rng.rand(96) < 0.2, 1:] = 0           # a lone position-0 level
    levels = (mags * rng.choice([-1, 1], size=mags.shape)).astype(np.int32)
    jt = JEncTables.from_level_costs(JC.LevelCosts(tables_probs))
    tt = EncTables.from_probs(tables_probs)
    for ctx in range(3):
        want = np.asarray(residual_costs_par(jnp.asarray(levels), ctype, first, ctx, jt))
        got = residual_costs(torch.from_numpy(levels)[None, None], ctype, first, ctx, tt)[0, 0]
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"ctx {ctx}")
    ctxs = rng.randint(0, 3, 96).astype(np.int32)
    want = np.asarray(residual_costs_par(jnp.asarray(levels), ctype, first, jnp.asarray(ctxs), jt))
    got = residual_costs(torch.from_numpy(levels)[None, None], ctype, first,
                         torch.from_numpy(ctxs)[None, None], tt)[0, 0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_rd_score_matches_jax():
    rng = np.random.RandomState(4)
    rate = rng.randint(0, 1 << 28, 4096).astype(np.int32)
    rate[:8] = [0, 1, 255, 256, (1 << 28) - 1, 1 << 20, 99999, 7]
    disto = rng.randint(0, 1 << 24, 4096).astype(np.int32)
    for lam in (1, 3, 187, 4107, 172800):
        want = np.asarray(_rd_score32(jnp.asarray(rate), jnp.asarray(disto), lam))
        got = rd_score32(torch.from_numpy(rate), torch.from_numpy(disto),
                         torch.tensor(lam, dtype=torch.int32))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def planes():
    return edev.rgb_to_planes([synthetic_frame(W, H, s) for s in (1, 2)])


@pytest.fixture(scope="module")
def params():
    qi = quality_to_quant_index(QUALITY)
    return EncParams.from_segment(SegmentParams(qi)), JEncParams(JSegmentParams(qi))


@pytest.mark.parametrize("tables", ["default", "random"])
@pytest.mark.parametrize("n_try", [0, 3])
def test_encode_analysis_matches_jax(planes, params, n_try, tables):
    P, JP = params
    probs = (np.stack([T.COEFF_PROBS_DEFAULT] * 2) if tables == "default"
             else _random_probs(31, 2))
    got = encode_analysis_batch(*edev.upload(planes, "cpu"), P, EncTables.from_probs(probs),
                                n_try)
    jp = [jnp.asarray(p) for p in planes]
    for i in range(2):
        # encode_analysis_batch_v2 takes one table set per call: image i's own.
        jt = JEncTables.from_level_costs(JC.LevelCosts(probs[i]))
        want = encode_analysis_batch_v2(*jp, JP, jt, MBW, MBH, n_try)
        for k, w in want.items():
            g = got[k][i].numpy()
            assert g.dtype == np.asarray(w).dtype, k
            np.testing.assert_array_equal(g, np.asarray(w)[i], err_msg=k)
    if n_try == 0:
        assert not (got["luma_mode"] == 4).any()


SEG_QUALITIES = ((30, 50, 75, 90), (20, 60, 80, 95))


@pytest.mark.parametrize("n_try,trellis", [(3, False), (4, True), (10, True)],
                         ids=["pass1", "trellis_m4", "trellis_m6"])
def test_encode_analysis_segments_trellis_match_jax(planes, n_try, trellis):
    """Per-MB segment parameters (seeded ids, four qualities per image) with
    and without the trellis, per-image random tables."""
    qis = [[quality_to_quant_index(q) for q in qs] for qs in SEG_QUALITIES]
    P = EncParams.from_segments([[SegmentParams(qi) for qi in row] for row in qis])
    sid = np.random.RandomState(5).randint(0, 4, (2, MBW * MBH)).astype(np.uint8)
    probs = _random_probs(37, 2)
    got = encode_analysis_batch(*edev.upload(planes, "cpu"), P, EncTables.from_probs(probs),
                                n_try, trellis, torch.from_numpy(sid))
    jp = [jnp.asarray(p) for p in planes]
    for i in range(2):
        JP = JEncParamsSegs.from_segments([[JSegmentParams(qi) for qi in qis[i]]])
        jt = JEncTables.from_level_costs(JC.LevelCosts(probs[i]))
        want = encode_analysis_batch_v2(*(p[i:i + 1] for p in jp), JP, jt, MBW, MBH, n_try,
                                        trellis, jnp.asarray(sid[i:i + 1]))
        for k, w in want.items():
            np.testing.assert_array_equal(got[k][i].numpy(), np.asarray(w)[0], err_msg=k)
    assert (got["luma_mode"] == 4).any() and (got["luma_mode"] != 4).any()

"""The trellis quantization's plain twin (`webp_tpu_torch/ops/trellis.py`,
which kernel K5 evaluates in `csrc/trellis.cuh`) against the JAX package's
`webp_tpu.ops.trellis2.trellis_par` / `trellis_spec3` and its host
`webp_tpu.encode.trellis.trellis_quantize`, on seeded numpy blocks: the
(token type, first position, lambda) cases of `tests/test_trellis2.py`,
entry contexts 0..2, all-zero blocks, blocks significant up to position 15
and coefficients that drive level0 to 2047, at several qualities.
Tolerance: bit-exact (integer arithmetic, int64 scores)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.common import vp8_tables as JT
from webp_tpu.encode import costs as JC
from webp_tpu.encode.quant import SegmentParams as JSegmentParams
from webp_tpu.encode.trellis import trellis_quantize
from webp_tpu.ops.encode_wavefront import EncTables as JEncTables
from webp_tpu.ops.trellis2 import trellis_par as jtrellis_par
from webp_tpu.ops.trellis2 import trellis_spec3 as jtrellis_spec3
from webp_tpu_torch.encode.quant import SegmentParams, quality_to_quant_index
from webp_tpu_torch.ops.enc_params import ZZ, EncParams, EncTables
from webp_tpu_torch.ops.trellis import trellis_par, trellis_spec3

CASES = [  # (ctype, first, lambda, matrix) as in tests/test_trellis2.py
    (0, 1, "lambda_trellis_i16", "y1"),
    (3, 0, "lambda_trellis_i4", "y1"),
    (2, 0, "lambda_trellis_i4", "uv"),
]


def _zzvec(mtx, attr):
    v = np.empty(16, np.int64)
    v[:] = getattr(mtx, attr)[1]
    v[0] = getattr(mtx, attr)[0]
    return v


def _blocks(seed: int) -> np.ndarray:
    """[96, 16] raster coefficients: magnitudes from 2 to 40000 (the largest
    push level0 to 2047 and keep the JAX kernel's int32 squares in range),
    40% zeros, all-zero blocks, blocks that reach position 15."""
    rng = np.random.RandomState(seed)
    parts = []
    for mag in (2, 12, 120, 1500, 12000, 40000):
        b = rng.randint(-mag, mag + 1, (14, 16))
        b[rng.rand(*b.shape) < 0.4] = 0
        parts.append(b)
    tail = rng.randint(-900, 901, (6, 16))
    tail[:, 15] = rng.choice([-700, 700], 6)  # raster 15 is zigzag 15
    parts += [tail, np.zeros((6, 16), np.int64)]
    return np.concatenate(parts).astype(np.int32)


def _args(seg, mtx_attr):
    mtx = getattr(seg, mtx_attr)
    return _zzvec(mtx, "q"), _zzvec(mtx, "iq"), np.asarray(mtx.sharpen)[ZZ]


@pytest.mark.parametrize("quality", [10, 75, 95])
@pytest.mark.parametrize("ctype,first,lam_attr,mtx_attr", CASES)
def test_trellis_par_matches_jax_and_host(quality, ctype, first, lam_attr, mtx_attr):
    qi = quality_to_quant_index(quality)
    seg, jseg = SegmentParams(qi), JSegmentParams(qi)
    assert getattr(seg, lam_attr) == getattr(jseg, lam_attr)
    q, iq, sharpen = _args(seg, mtx_attr)
    np.testing.assert_array_equal(sharpen, np.asarray(getattr(jseg, mtx_attr).sharpen)[ZZ])
    lam = getattr(seg, lam_attr)
    coeffs = _blocks(quality * 4 + ctype)
    ctx0 = np.random.RandomState(quality + ctype).randint(0, 3, len(coeffs))
    probs = np.random.RandomState(quality).randint(1, 256, (4, 8, 3, 11)).astype(np.uint8)
    tt = EncTables.from_probs(probs)
    jt = JEncTables.from_level_costs(JC.LevelCosts(probs))

    got_lv, got_nz = trellis_par(torch.from_numpy(coeffs), torch.from_numpy(q), torch.from_numpy(iq),
                                 torch.from_numpy(sharpen), lam, first,
                                 torch.from_numpy(ctx0), tt.cls_cost[0, ctype],
                                 tt.eob_cost[0, ctype], tt.init_cost[0, ctype])
    want_lv, want_nz = trellis_quantize(coeffs.astype(np.int64), getattr(jseg, mtx_attr), lam,
                                        first, JC.LevelCosts(probs), ctype, ctx0)
    np.testing.assert_array_equal(got_lv.numpy(), want_lv)
    np.testing.assert_array_equal(got_nz.numpy(), want_nz)
    jlv, jnz = jtrellis_par(jnp.asarray(coeffs), jnp.asarray(q.astype(np.int32)),
                            jnp.asarray(iq.astype(np.int32)), jnp.asarray(sharpen.astype(np.int32)),
                            int(lam), ctype, first, jnp.asarray(ctx0.astype(np.int32)),
                            jt.cls_cost[ctype], jt.eob_cost[ctype], jt.init_cost[ctype])
    np.testing.assert_array_equal(got_lv.numpy(), np.asarray(jlv))
    np.testing.assert_array_equal(got_nz.numpy(), np.asarray(jnz))
    if quality == 95 and ctype != 2:
        assert int(got_lv.abs().max()) == 2047
    assert got_lv[-6:].abs().sum() == 0 and not got_nz[-6:].any()


@pytest.mark.parametrize("quality", [30, 75])
def test_trellis_spec3_matches_jax(quality):
    """All three entry contexts at once, as the I16 path runs it, against
    the JAX package's trellis_spec3 (the I16 case: y1, token type 0)."""
    qi = quality_to_quant_index(quality)
    seg = SegmentParams(qi)
    q, iq, sharpen = _args(seg, "y1")
    lam = seg.lambda_trellis_i16
    coeffs = _blocks(quality)
    probs = np.random.RandomState(3).randint(1, 256, (4, 8, 3, 11)).astype(np.uint8)
    tt = EncTables.from_probs(probs)
    jt = JEncTables.from_level_costs(JC.LevelCosts(probs))
    got_lv, got_nz = trellis_spec3(torch.from_numpy(coeffs), torch.from_numpy(q),
                                   torch.from_numpy(iq), torch.from_numpy(sharpen), lam, 1,
                                   tt.cls_cost[0, 0], tt.eob_cost[0, 0], tt.init_cost[0, 0])
    jlv, jnz = jtrellis_spec3(jnp.asarray(coeffs), jnp.asarray(q.astype(np.int32)),
                              jnp.asarray(iq.astype(np.int32)),
                              jnp.asarray(sharpen.astype(np.int32)), int(lam), 0, 1,
                              jt.cls_cost[0], jt.eob_cost[0], jt.init_cost[0])
    np.testing.assert_array_equal(got_lv.numpy(), np.asarray(jlv))
    np.testing.assert_array_equal(got_nz.numpy(), np.asarray(jnz))
    for c in range(3):  # each context equals the single-context DP
        lv, nz = trellis_par(torch.from_numpy(coeffs), torch.from_numpy(q), torch.from_numpy(iq),
                             torch.from_numpy(sharpen), lam, 1, c, tt.cls_cost[0, 0],
                             tt.eob_cost[0, 0], tt.init_cost[0, 0])
        assert torch.equal(got_lv[:, c], lv) and torch.equal(got_nz[:, c], nz)


def test_segment_params_carry_the_trellis_fields():
    """The port's `SegmentParams` and `EncParams` carry the JAX package's
    sharpening, trellis lambdas, quantizer level and loop-filter slot."""
    for qi in (0, 37, 127):
        for delta in (-9, 0, 5):
            s, j = SegmentParams(qi, delta, 3, -1), JSegmentParams(qi, delta, 3, -1)
            for attr in ("quant_index", "quantizer_level", "uv_ac_delta", "uv_dc_delta",
                         "lf_level", "lambda_trellis_i4", "lambda_trellis_i16",
                         "lambda_trellis_uv", "lambda_i4", "lambda_i16", "lambda_uv",
                         "lambda_mode", "tlambda"):
                assert getattr(s, attr) == getattr(j, attr), attr
            for m in ("y1", "y2", "uv"):
                np.testing.assert_array_equal(getattr(s, m).sharpen, getattr(j, m).sharpen)
    P = EncParams.from_segment(SegmentParams(40))
    assert P.packed("cpu").shape == (1, 4, EncParams.SIZE)

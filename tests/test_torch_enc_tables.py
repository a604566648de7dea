"""Kernel K7's plain twin (`ops/enc_tables.py`) against the JAX package's
`enc_tables_from_probs` and its host `LevelCosts`, on seeded random token
probabilities (the full 0..255 range, the default set, and the sets pass 1
adapts to).  Tolerance: bit-exact (integer tables)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.encode import costs as JC
from webp_tpu.ops.encode_wavefront import EncTables as JEncTables
from webp_tpu.ops.encode_wavefront2 import enc_tables_from_probs
from webp_tpu_torch.common import vp8_tables as T
from webp_tpu_torch.encode import device as edev
from webp_tpu_torch.ops.enc_params import CONSTS_NP, EncTables
from webp_tpu_torch.ops.enc_tables import enc_tables, enc_tables_plain

from synthetic_rgb import synthetic_frame

B = 4


@pytest.fixture(scope="module")
def probs():
    rng = np.random.RandomState(17)
    p = rng.randint(0, 256, (B, 4, 8, 3, 11)).astype(np.uint8)
    p[0] = T.COEFF_PROBS_DEFAULT
    p[1, 0] = 0
    p[1, 1] = 255
    return p


@pytest.fixture(scope="module")
def jax_tables(probs):
    return enc_tables_from_probs(jnp.asarray(probs))


@pytest.mark.parametrize("field", EncTables.FIELDS)
def test_enc_tables_twin_matches_jax(probs, jax_tables, field):
    got = getattr(enc_tables(torch.from_numpy(probs)), field)
    want = np.asarray(getattr(jax_tables, field))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_host_tables_match_twin(probs):
    """`EncTables.from_probs` (host LevelCosts) is what K7 computes."""
    host = EncTables.from_probs(probs)
    twin = enc_tables_plain(torch.from_numpy(probs))
    for f in EncTables.FIELDS:
        assert torch.equal(getattr(host, f), getattr(twin, f)), f


def test_constant_tables_match_jax():
    """The fixed tables K5 reads beside the per-image costs."""
    t = JEncTables.from_level_costs(JC.cached_level_costs(T.COEFF_PROBS_DEFAULT))
    want = np.concatenate([np.asarray(a).reshape(-1) for a in (
        t.fixed, t.fixed_i4, t.fixed_i16, t.fixed_uv, t.weight_y)])
    np.testing.assert_array_equal(CONSTS_NP, want)


def test_adapted_probs_match_jax():
    """Pass 1's probability adaptation: the port's `adapt_probs` against the
    JAX package's `ProbaStats.updated_probs` on seeded token counts."""
    rng = np.random.RandomState(3)
    totals = rng.randint(0, 5000, (3, 4, 8, 3, 11))
    totals[0, 0] = 0
    ones = (totals * rng.rand(*totals.shape)).astype(np.int64)
    got = edev.adapt_probs(totals, ones)
    for i in range(3):
        st = JC.ProbaStats()
        st.total += totals[i]
        st.ones += ones[i]
        np.testing.assert_array_equal(got[i], st.updated_probs(T.COEFF_PROBS_DEFAULT.copy()))


def test_synthetic_frames_are_seeded():
    a = synthetic_frame(70, 44, 5)
    assert a.shape == (44, 70, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, synthetic_frame(70, 44, 5))
    assert not np.array_equal(a, synthetic_frame(70, 44, 6))

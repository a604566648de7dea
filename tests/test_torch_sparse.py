"""The image-flat sparse level format of the port (`webp_tpu_torch/ops/
sparse.py`: K21 `pack_levels`, K22 `expand_levels` and the host copies) on
the CPU against the JAX package's `webp_tpu/ops/sparse.py`
(`device_pack_levels`, `device_expand_levels`, `host_pack_levels`,
`host_expand_levels`), on the seeded arrays of `sparse_inputs.py` at 8, 23
and 40 MBs (B = 1 and 3): densities 0, 0.05, 0.23, 0.31 and 1, exactly at
the cap, over it, +-127 and -128; the expansion also on random bitmaps and
values (the pad nonzero, ranks past the cap taking vals[cap - 1]) and with
n not a multiple of 8.  Tolerance: 0 (integers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.ops import sparse as J
from webp_tpu_torch.ops import sparse as S

from sparse_inputs import flat_cases

CASES = ("density_0", "density_0.05", "density_0.23", "density_0.31", "density_1", "at_cap",
         "over_cap", "extremes")
GEOMETRIES = [(1, 23), (3, 8), (3, 40)]  # (B, nmb)


def _case(name, B, nmb):
    flat, cap = flat_cases(B, nmb, seed=nmb)[name]
    return flat, cap


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("B,nmb", GEOMETRIES, ids=lambda v: str(v))
@pytest.mark.parametrize("name", CASES)
def test_pack_matches_jax(name, B, nmb):
    flat, cap = _case(name, B, nmb)
    got = S.pack_levels(torch.from_numpy(flat), cap)
    want = J.device_pack_levels(jnp.asarray(flat), cap)
    for g, w, what in zip(got, want, ("bitmap", "vals", "overflow")):
        assert np.array_equal(_np(g), np.asarray(w)), what
    count = (flat != 0).sum(1)
    assert np.array_equal(_np(got[2]), count > cap)
    if name == "at_cap":
        assert (count == cap).all() and not _np(got[2]).any()
    if name == "over_cap":
        assert _np(got[2]).all()


@pytest.mark.parametrize("B,nmb", GEOMETRIES, ids=lambda v: str(v))
@pytest.mark.parametrize("name", CASES)
def test_expand_matches_jax(name, B, nmb):
    """The JAX pack's (bitmap, vals) expanded, over the whole bitmap and over
    its first n - 5 bits."""
    flat, cap = _case(name, B, nmb)
    bitmap, vals, _ = (np.array(a) for a in J.device_pack_levels(jnp.asarray(flat), cap))
    n = flat.shape[1]
    for nn in (n, n - 5):
        got = S.expand_levels(torch.from_numpy(bitmap), torch.from_numpy(vals), nn)
        want = np.asarray(J.device_expand_levels(jnp.asarray(bitmap), jnp.asarray(vals), nn))
        assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    count = (flat != 0).sum(1)
    full = S.expand_levels(torch.from_numpy(bitmap), torch.from_numpy(vals), n).numpy()
    for b in range(B):
        if count[b] <= cap:  # the round trip within the cap
            assert np.array_equal(full[b], flat[b])
        else:  # past the cap every set slot repeats vals[cap - 1]
            past = np.flatnonzero(flat[b])[cap:]
            assert (full[b, past] == vals[b, cap - 1]).all()


@pytest.mark.parametrize("n_minus", [0, 1, 3, 7])
@pytest.mark.parametrize("cap", [1, 5, 100, 700])
def test_expand_random_bitmaps_match_jax(cap, n_minus):
    """Random bytes and values: nonzero pads, ranks past a small cap."""
    rng = np.random.RandomState(cap * 8 + n_minus)
    B, nb = 3, 96
    bitmap = rng.randint(0, 256, (B, nb)).astype(np.uint8)
    vals = rng.randint(-128, 128, (B, cap)).astype(np.int8)
    n = 8 * nb - n_minus
    got = S.expand_levels(torch.from_numpy(bitmap), torch.from_numpy(vals), n)
    want = np.asarray(J.device_expand_levels(jnp.asarray(bitmap), jnp.asarray(vals), n))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", CASES)
def test_host_copies_match_jax(name):
    flat, cap = _case(name, 3, 23)
    n = flat.shape[1]
    for b in range(3):
        bm, vals, ok = S.host_pack_levels(flat[b], cap)
        jbm, jvals, jok = J.host_pack_levels(flat[b], cap)
        assert ok == jok and np.array_equal(bm, jbm)
        assert (vals is None) == (jvals is None)
        if ok:
            assert np.array_equal(vals, jvals)
            for nn in (n, n - 3):
                got = S.host_expand_levels(bm, vals, nn)
                assert np.array_equal(got, J.host_expand_levels(jbm, jvals, nn))
                assert np.array_equal(got, flat[b, :nn])
        else:  # an over-cap bitmap: the host expansion raises, the flat one clips
            trunc = np.asarray(J.device_pack_levels(jnp.asarray(flat[b:b + 1]), cap)[1])[0]
            for fn in (S.host_expand_levels, J.host_expand_levels):
                with pytest.raises(ValueError):
                    fn(bm, trunc, n)
    assert S.cap_for(23) == J.cap_for(23)


def test_refusals():
    with pytest.raises(ValueError):
        S.pack_levels(torch.zeros((2, 404), dtype=torch.int8), 10)  # N % 8 != 0
    with pytest.raises(AssertionError):
        J.device_pack_levels(jnp.zeros((2, 404), jnp.int8), 10)
    with pytest.raises(ValueError):
        S.pack_levels(torch.zeros((2, 400), dtype=torch.int16), 10)
    bm = torch.zeros((2, 50), dtype=torch.uint8)
    with pytest.raises(ValueError):
        S.expand_levels(bm, torch.zeros((2, 4), dtype=torch.int8), 401)  # n > 8 nb
    with pytest.raises(ValueError):
        S.expand_levels(bm, torch.zeros((2, 0), dtype=torch.int8), 400)  # cap 0

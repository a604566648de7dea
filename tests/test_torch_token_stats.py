"""Kernel K6's plain twin (`ops/token_stats.py`) against the JAX package's
`token_stats_device` and the host C++ `vp8_token_stats` over the port's
token stream, on seeded level arrays: magnitudes past 67 (the last token
class) and 2047 (the level cap), all luma modes, skipped MBs, a geometry
whose Y2 contexts skip B-predicted MBs.  Also the port's host contexts
against the JAX package's.  Tolerance: bit-exact (integer counts)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.encode.contexts import compute_contexts as jax_package_contexts
from webp_tpu.ops.token_stats import token_stats_device
from webp_tpu_torch.encode import device as edev
from webp_tpu_torch.encode import vp8 as tvp8
from webp_tpu_torch.encode.contexts import compute_contexts
from webp_tpu_torch.io import native
from webp_tpu_torch.ops.token_stats import token_stats

MBW, MBH, B = 6, 5, 3


def _arrays(seed: int):
    """Seeded analysis arrays [B, nmb, ...] as numpy (levels int16)."""
    rng = np.random.RandomState(seed)
    nmb = MBW * MBH
    mags = rng.choice([0] * 6 + [1, 1, 2, 3, 4, 5, 6, 7, 10, 11, 18, 34, 35, 66, 67, 68, 500,
                                 2047, 3000], size=(B, nmb, 25, 16))
    mags[rng.rand(B, nmb, 25) < 0.3] = 0  # empty blocks
    lv = mags * rng.choice([-1, 1], size=mags.shape)
    lv[rng.rand(B, nmb) < 0.15] = 0       # skipped MBs
    lv = np.clip(lv, -2047, 2047).astype(np.int16)
    luma_mode = rng.choice([0, 1, 2, 3, 4, 4], size=(B, nmb)).astype(np.uint8)
    y2 = lv[:, :, 0].copy()
    y2[luma_mode == 4] = 0
    y = lv[:, :, 1:17].copy()
    y[..., 0] = np.where((luma_mode != 4)[..., None], 0, y[..., 0])  # I16: DC rides in Y2
    return dict(luma_mode=luma_mode, y2_levels=y2, y_levels=y, uv_levels=lv[:, :, 17:].copy())


@pytest.fixture(scope="module", params=[1, 2], ids=["seed1", "seed2"])
def arrays(request):
    return _arrays(request.param)


def _port_stats(a):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items()}
    return token_stats(t["luma_mode"], t["y2_levels"], t["y_levels"], t["uv_levels"],
                       edev.skip_flags(t), MBW, MBH)


def test_token_stats_twin_matches_jax(arrays):
    j = {k: jnp.asarray(v.astype(np.int32)) for k, v in arrays.items()}
    skipped = ((j["y_levels"] == 0).all(axis=(-1, -2)) & (j["uv_levels"] == 0).all(axis=(-1, -2))
               & (j["y2_levels"] == 0).all(axis=-1))
    want = token_stats_device(j["luma_mode"], j["y2_levels"], j["y_levels"], j["uv_levels"],
                              skipped, MBW, MBH)
    got = _port_stats(arrays)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_token_stats_twin_matches_host_coder(arrays):
    """The same counts as the C++ walk over the finisher's token stream."""
    got = _port_stats(arrays)
    for i in range(B):
        a = {k: v[i].astype(np.int32) for k, v in arrays.items()}
        ctx = compute_contexts(a["luma_mode"], a["y2_levels"], a["y_levels"], a["uv_levels"],
                               MBW, MBH)
        levels, meta = tvp8.token_stream(a, ctx, tvp8.skip_flags(a), MBW)
        totals, ones = native.vp8_token_stats(levels, meta)
        np.testing.assert_array_equal(got[0][i].numpy(), totals)
        np.testing.assert_array_equal(got[1][i].numpy(), ones)


def test_host_contexts_match_jax_package(arrays):
    for i in range(B):
        a = {k: v[i].astype(np.int32) for k, v in arrays.items()}
        got = compute_contexts(a["luma_mode"], a["y2_levels"], a["y_levels"], a["uv_levels"],
                               MBW, MBH)
        skipped = tvp8.skip_flags(a)
        want = jax_package_contexts(a["luma_mode"], a["y2_levels"], a["y_levels"],
                                    a["uv_levels"], skipped, MBW, MBH)
        for k in ("y2_ctx", "y_ctx", "uv_ctx", "has_y2"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

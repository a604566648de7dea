"""K4 (fancy upsampling + YUV -> RGB): the port's plain path against
`webp_tpu.ops.jax_ops.fancy_yuv420_to_rgb`, at even and odd crops of
MB-padded planes.  Tolerance: bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.ops import jax_ops
from webp_tpu_torch.ops import yuv


def _planes(mbw, mbh, seed, batch=2):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (batch, mbh * 16, mbw * 16)).astype(np.uint8),
            rng.randint(0, 256, (batch, mbh * 8, mbw * 8)).astype(np.uint8),
            rng.randint(0, 256, (batch, mbh * 8, mbw * 8)).astype(np.uint8))


SIZES = [(64, 48), (72, 40), (63, 47), (17, 1), (1, 17), (1, 1)]


@pytest.mark.parametrize("width,height", SIZES)
def test_fancy_yuv420_to_rgb_matches_jax(width, height):
    mbw, mbh = (width + 15) // 16, (height + 15) // 16
    planes = _planes(mbw, mbh, seed=width * 31 + height)
    want = np.asarray(jax_ops.fancy_yuv420_to_rgb(*(jnp.asarray(p) for p in planes), width, height))
    got = yuv.fancy_yuv420_to_rgb(*(torch.from_numpy(p) for p in planes), width, height)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, height, width, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_yuv_to_rgb_extremes_match_jax():
    v = np.arange(256, dtype=np.uint8)
    y, u, vv = (a.reshape(-1) for a in np.meshgrid(v[::15], v[::5], v[::5], indexing="ij"))
    want = np.asarray(jax_ops.yuv_to_rgb(jnp.asarray(y), jnp.asarray(u), jnp.asarray(vv)))
    got = yuv.yuv_to_rgb(torch.from_numpy(y), torch.from_numpy(u), torch.from_numpy(vv))
    np.testing.assert_array_equal(got.numpy(), want)

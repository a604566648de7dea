"""webp_tpu_torch.ops.transform against webp_tpu.ops.jax_ops: bit-exact.

The decode transforms see dequantized levels (|level| <= 2048 times a
dequant factor <= 157 for luma/chroma, <= 284*155/100 for Y2); the ranges
below cover those and the small values most blocks carry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.ops import jax_ops
from webp_tpu_torch.ops import transform

RANGES = [16, 2048, 2048 * 157, 2048 * 440]


@pytest.mark.parametrize("bound", RANGES)
@pytest.mark.parametrize("name", ["idct4x4", "iwht4x4"])
def test_transform_matches_jax(name, bound):
    rng = np.random.RandomState(bound % 1000 + len(name))
    blocks = rng.randint(-bound, bound + 1, size=(64, 24, 16)).astype(np.int32)
    want = np.asarray(getattr(jax_ops, name)(jnp.asarray(blocks)))
    got = getattr(transform, name)(torch.from_numpy(blocks)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_idct_of_dc_only_block_is_the_shortcut():
    """An AC-free block's IDCT equals (dc + 4) >> 3 everywhere: why K1 runs
    the IDCT unconditionally."""
    dc = torch.arange(-4096, 4096, 7, dtype=torch.int32)
    blocks = torch.zeros((len(dc), 16), dtype=torch.int32)
    blocks[:, 0] = dc
    got = transform.idct4x4(blocks)
    assert torch.equal(got, ((dc + 4) >> 3)[:, None].expand(-1, 16))

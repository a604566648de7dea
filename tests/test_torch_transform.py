"""webp_tpu_torch.ops.transform against webp_tpu.ops.jax_ops: bit-exact.

The decode transforms see dequantized levels (|level| <= 2048 times a
dequant factor <= 157 for luma/chroma, <= 284*155/100 for Y2); the ranges
below cover those and the small values most blocks carry.  The encode's
forward DCT sees residuals in -255..255, its WHT the 16 DCs of a
macroblock, and the quantizer coefficients below 2^16 with every
quantizer step of the tables.
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


@pytest.mark.parametrize("name,bound", [("dct4x4", 255), ("dct4x4", 3), ("wht4x4", 4080 * 8)])
def test_forward_transform_matches_jax(name, bound):
    rng = np.random.RandomState(bound + len(name))
    blocks = rng.randint(-bound, bound + 1, size=(512, 16)).astype(np.int32)
    want = np.asarray(getattr(jax_ops, name)(jnp.asarray(blocks)))
    got = getattr(transform, name)(torch.from_numpy(blocks)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_quantize_zz_matches_jax():
    from webp_tpu_torch.encode.quant import SegmentParams

    rng = np.random.RandomState(8)
    coeffs = rng.randint(-(1 << 16) + 1, 1 << 16, size=(64, 16)).astype(np.int32)
    coeffs[:, 1:] //= rng.randint(1, 300, size=(64, 15))
    for qi in (0, 37, 90, 127):
        for m in ("y1", "y2", "uv"):
            mtx = getattr(SegmentParams(qi), m)
            iq = np.full(16, mtx.iq[1], np.int32)
            bias = np.full(16, mtx.bias[1], np.int32)
            iq[0], bias[0] = mtx.iq[0], mtx.bias[0]
            want = np.asarray(jax_ops.quantize_zz(jnp.asarray(coeffs), jnp.asarray(iq),
                                                  jnp.asarray(bias)))
            got = transform.quantize_zz(torch.from_numpy(coeffs), torch.from_numpy(iq),
                                        torch.from_numpy(bias))
            np.testing.assert_array_equal(got.numpy(), want)

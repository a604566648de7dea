"""Frozen copy of the plain code of `webp_tpu_torch/ops/transform.py`, the
benchmark's reference; it imports nothing of the port.

4x4 transforms on int32 tensors: the decode's inverse ones (RFC 6386
section 14.3) and the encode's forward DCT/WHT (libwebp rounding) with the
biased zigzag quantizer.

Plain torch twins of `webp_tpu/ops/jax_ops.py` `idct4x4` / `iwht4x4` /
`dct4x4` / `wht4x4` / `quantize_zz`; the CUDA kernels in `csrc/residual.cu`
and `csrc/enc.cu` compute the same integer arithmetic.
"""

from __future__ import annotations

import torch

C1 = 20091
C2 = 35468


def _mul16(a: torch.Tensor, c: int) -> torch.Tensor:
    """Exact (a * c) >> 16 (the product is formed in int64)."""
    return ((a.to(torch.int64) * c) >> 16).to(torch.int32)


def idct4x4(blocks: torch.Tensor) -> torch.Tensor:
    """Inverse DCT on [..., 16] integer blocks -> int32 [..., 16]."""
    b = blocks.to(torch.int32).reshape(*blocks.shape[:-1], 4, 4)
    r0, r1, r2, r3 = b[..., 0, :], b[..., 1, :], b[..., 2, :], b[..., 3, :]
    a1 = r0 + r2
    b1 = r0 - r2
    c1 = _mul16(r1, C2) - (r3 + _mul16(r3, C1))
    d1 = (r1 + _mul16(r1, C1)) + _mul16(r3, C2)
    t = torch.stack([a1 + d1, b1 + c1, b1 - c1, a1 - d1], dim=-2)
    c0, c1_, c2_, c3 = t[..., 0], t[..., 1], t[..., 2], t[..., 3]
    a1 = c0 + c2_
    b1 = c0 - c2_
    cc = _mul16(c1_, C2) - (c3 + _mul16(c3, C1))
    dd = (c1_ + _mul16(c1_, C1)) + _mul16(c3, C2)
    out = torch.stack(
        [(a1 + dd + 4) >> 3, (b1 + cc + 4) >> 3, (b1 - cc + 4) >> 3, (a1 - dd + 4) >> 3],
        dim=-1,
    )
    return out.reshape(blocks.shape)


def iwht4x4(blocks: torch.Tensor) -> torch.Tensor:
    """Inverse Walsh-Hadamard transform of the Y2 block, [..., 16] -> int32."""
    b = blocks.to(torch.int32).reshape(*blocks.shape[:-1], 4, 4)
    r0, r1, r2, r3 = b[..., 0, :], b[..., 1, :], b[..., 2, :], b[..., 3, :]
    t = torch.stack(
        [(r0 + r3) + (r1 + r2), (r1 - r2) + (r0 - r3),
         (r0 + r3) - (r1 + r2), (r0 - r3) - (r1 - r2)],
        dim=-2,
    )
    c0, c1_, c2_, c3 = t[..., 0], t[..., 1], t[..., 2], t[..., 3]
    a1 = c0 + c3
    b1 = c1_ + c2_
    c1n = c1_ - c2_
    d1 = c0 - c3
    out = torch.stack(
        [(a1 + b1 + 3) >> 3, (c1n + d1 + 3) >> 3, (a1 - b1 + 3) >> 3, (d1 - c1n + 3) >> 3],
        dim=-1,
    )
    return out.reshape(blocks.shape)


def dct4x4(blocks: torch.Tensor) -> torch.Tensor:
    """Forward DCT of [..., 16] row-major residual blocks -> int32 [..., 16]."""
    blk = blocks.to(torch.int32).reshape(*blocks.shape[:-1], 4, 4)
    e0, e1, e2, e3 = blk[..., 0], blk[..., 1], blk[..., 2], blk[..., 3]
    a = (e0 + e3) * 8
    b = (e1 + e2) * 8
    c = (e1 - e2) * 8
    d = (e0 - e3) * 8
    t = torch.stack([a + b, (c * 2217 + d * 5352 + 14500) >> 12, a - b,
                     (d * 2217 - c * 5352 + 7500) >> 12], dim=-1)
    c0, c1_, c2_, c3 = t[..., 0, :], t[..., 1, :], t[..., 2, :], t[..., 3, :]
    a = c0 + c3
    b = c1_ + c2_
    c = c1_ - c2_
    d = c0 - c3
    out = torch.stack([
        (a + b + 7) >> 4,
        ((c * 2217 + d * 5352 + 12000) >> 16) + (d != 0).to(torch.int32),
        (a - b + 7) >> 4,
        (d * 2217 - c * 5352 + 51000) >> 16,
    ], dim=-2)
    return out.reshape(blocks.shape)


def wht4x4(blocks: torch.Tensor) -> torch.Tensor:
    """Forward Walsh-Hadamard transform of the 16 luma DCs, [..., 16] -> int32."""
    b = blocks.to(torch.int32).reshape(*blocks.shape[:-1], 4, 4)
    e0, e1, e2, e3 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    t = torch.stack([(e0 + e3) + (e1 + e2), (e1 - e2) + (e0 - e3),
                     (e0 + e3) - (e1 + e2), (e0 - e3) - (e1 - e2)], dim=-1)
    c0, c1_, c2_, c3 = t[..., 0, :], t[..., 1, :], t[..., 2, :], t[..., 3, :]
    vals = [(c0 + c3) + (c1_ + c2_), (c1_ - c2_) + (c0 - c3),
            (c0 + c3) - (c1_ + c2_), (c0 - c3) - (c1_ - c2_)]
    # Halve, rounding positive values up and negative ones toward zero.
    out = torch.stack([torch.where(v >= 0, (v + (v > 0).to(torch.int32)) >> 1, -((-v) >> 1))
                       for v in vals], dim=-2)
    return out.reshape(blocks.shape)


def quantize_zz(blocks_zz: torch.Tensor, iq, bias) -> torch.Tensor:
    """Biased quantization (QFIX 17) of zigzag-ordered coefficients [..., 16]:
    sign(c) * min((|c| * iq + bias) >> 17, 2047), int32."""
    c = blocks_zz.to(torch.int32)
    level = torch.clamp_max((c.abs() * iq + bias) >> 17, 2047)
    return torch.where(c < 0, -level, level)

"""Frozen copy of `webp_tpu/ops/transform.py` (numpy), part of the
benchmark's reference decoder; `src/` paths name the Rust reference codec's
sources.

Batched 4x4 DCT / WHT transforms with exact VP8 integer semantics.

Numpy reference implementations operate on arrays of blocks shaped [..., 16]
(row-major 4x4) so the same code path serves one block or a whole frame's
worth. Constants 20091/35468 and rounding per RFC 6386 §14.3-14.4; parity
reference `src/common/transform.rs:5-157`.

The JAX mirrors in `webp_tpu.ops.jax_transform` are bit-exact ports of these
(verified by tests) and form the device decode path.
"""

from __future__ import annotations

import numpy as np

C1 = 20091  # (cos(pi/8)*sqrt(2) - 1) << 16
C2 = 35468  # sin(pi/8)*sqrt(2) << 16


def idct4x4(blocks: np.ndarray) -> np.ndarray:
    """Inverse DCT on [..., 16] int blocks; returns int32 residuals."""
    b = blocks.astype(np.int64).reshape(*blocks.shape[:-1], 4, 4)
    # Columns pass.
    r0, r1, r2, r3 = b[..., 0, :], b[..., 1, :], b[..., 2, :], b[..., 3, :]
    a1 = r0 + r2
    b1 = r0 - r2
    c1 = ((r1 * C2) >> 16) - (r3 + ((r3 * C1) >> 16))
    d1 = (r1 + ((r1 * C1) >> 16)) + ((r3 * C2) >> 16)
    t = np.stack([a1 + d1, b1 + c1, b1 - c1, a1 - d1], axis=-2)
    # Rows pass with final rounding.
    c0, c1_, c2_, c3 = t[..., 0], t[..., 1], t[..., 2], t[..., 3]
    a1 = c0 + c2_
    b1 = c0 - c2_
    cc = ((c1_ * C2) >> 16) - (c3 + ((c3 * C1) >> 16))
    dd = (c1_ + ((c1_ * C1) >> 16)) + ((c3 * C2) >> 16)
    out = np.stack(
        [(a1 + dd + 4) >> 3, (b1 + cc + 4) >> 3, (b1 - cc + 4) >> 3, (a1 - dd + 4) >> 3],
        axis=-1,
    )
    return out.reshape(blocks.shape).astype(np.int32)


def idct4x4_dc(blocks: np.ndarray) -> np.ndarray:
    """DC-only inverse transform: broadcast (DC+4)>>3 to all 16 positions."""
    dc = (blocks[..., 0:1].astype(np.int32) + 4) >> 3
    return np.broadcast_to(dc, blocks.shape).copy()


def iwht4x4(blocks: np.ndarray) -> np.ndarray:
    """Inverse Walsh-Hadamard (Y2 DC plane) on [..., 16] blocks."""
    b = blocks.astype(np.int64).reshape(*blocks.shape[:-1], 4, 4)
    r0, r1, r2, r3 = b[..., 0, :], b[..., 1, :], b[..., 2, :], b[..., 3, :]
    a1 = r0 + r3
    b1 = r1 + r2
    c1 = r1 - r2
    d1 = r0 - r3
    t = np.stack([a1 + b1, c1 + d1, a1 - b1, d1 - c1], axis=-2)
    c0, c1_, c2_, c3 = t[..., 0], t[..., 1], t[..., 2], t[..., 3]
    a1 = c0 + c3
    b1 = c1_ + c2_
    c1n = c1_ - c2_
    d1 = c0 - c3
    out = np.stack(
        [(a1 + b1 + 3) >> 3, (c1n + d1 + 3) >> 3, (a1 - b1 + 3) >> 3, (d1 - c1n + 3) >> 3],
        axis=-1,
    )
    return out.reshape(blocks.shape).astype(np.int32)


def wht4x4(blocks: np.ndarray) -> np.ndarray:
    """Forward Walsh-Hadamard (encoder Y2 path)."""
    b = blocks.astype(np.int64).reshape(*blocks.shape[:-1], 4, 4)
    # Vertical pass runs along each row in the reference's layout.
    r0, r1, r2, r3 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    a = r0 + r3
    bb = r1 + r2
    c = r1 - r2
    d = r0 - r3
    t = np.stack([a + bb, c + d, a - bb, d - c], axis=-1)
    c0, c1_, c2_, c3 = t[..., 0, :], t[..., 1, :], t[..., 2, :], t[..., 3, :]
    a1 = c0 + c3
    b1 = c1_ + c2_
    cc = c1_ - c2_
    d1 = c0 - c3
    a2, b2, c2n, d2 = a1 + b1, cc + d1, a1 - b1, d1 - cc

    def half(v):
        # (v + (v>0)) / 2 with Rust truncating division semantics.
        return np.where(v >= 0, (v + (v > 0).astype(np.int64)) // 2, -((-v) // 2))

    out = np.stack([half(a2), half(b2), half(c2n), half(d2)], axis=-2)
    return out.reshape(blocks.shape).astype(np.int32)


def dct4x4(blocks: np.ndarray) -> np.ndarray:
    """Forward DCT with libwebp rounding (encoder path).

    Reference `src/common/transform.rs:176-207`: constants 2217/5352 and
    rounding terms 14500/7500 (rows) then 12000/51000 (columns).
    """
    blk = blocks.astype(np.int64).reshape(*blocks.shape[:-1], 4, 4)
    # Per-row pass, inputs pre-scaled by 8.
    e0, e1, e2, e3 = blk[..., 0], blk[..., 1], blk[..., 2], blk[..., 3]
    a = (e0 + e3) * 8
    b = (e1 + e2) * 8
    c = (e1 - e2) * 8
    d = (e0 - e3) * 8
    t = np.stack(
        [a + b, (c * 2217 + d * 5352 + 14500) >> 12, a - b, (d * 2217 - c * 5352 + 7500) >> 12],
        axis=-1,
    )
    # Per-column pass with final rounding; the +1 bias applies when the
    # column's 0-3 difference is nonzero.
    c0, c1_, c2_, c3 = t[..., 0, :], t[..., 1, :], t[..., 2, :], t[..., 3, :]
    a = c0 + c3
    b = c1_ + c2_
    c = c1_ - c2_
    d = c0 - c3
    out = np.stack(
        [
            (a + b + 7) >> 4,
            ((c * 2217 + d * 5352 + 12000) >> 16) + (d != 0).astype(np.int64),
            (a - b + 7) >> 4,
            (d * 2217 - c * 5352 + 51000) >> 16,
        ],
        axis=-2,
    )
    return out.reshape(blocks.shape).astype(np.int32)

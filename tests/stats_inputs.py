"""Seeded inputs of the statistics kernels, K8 (segment analysis) and K6
(token statistics), for `tests/test_torch_stats_rows.py` (the CPU twins of
their schedules against the JAX package) and `tests/test_torch_cuda.py`
(the kernels on the card).  Imports neither jax nor the JAX package.

`level_arrays` makes pass-1-like level arrays as
`tests/test_torch_token_stats.py:_arrays` does (magnitudes across every
token class, 66/67/68 at the last class's edge, 2047 and 3000; empty
blocks, skipped MBs, all luma modes), optionally every MB B-predicted
(the Y2 contexts' longest scans), most MBs B-predicted, or every MB
skipped.  `planes` makes YUV420 planes of a flat frame (every coefficient
in bin 0 but the borders'), of noise, or of a mix of the two by MB.
"""

from __future__ import annotations

import numpy as np

MAGS = [0] * 6 + [1, 1, 2, 3, 4, 5, 6, 7, 10, 11, 18, 19, 34, 35, 66, 67, 68, 500, 2047, 3000]


def level_arrays(batch: int, mbw: int, mbh: int, seed: int, all_b: bool = False,
                 skip_all: bool = False, clip: bool = True, b_share: float = 0.0) -> dict:
    """luma_mode [B, nmb] uint8, y2_levels [B, nmb, 16], y_levels [B, nmb,
    16, 16], uv_levels [B, nmb, 8, 16] int16; |level| clipped to 2047
    unless `clip` is False; with `b_share`, that share of MBs B-predicted
    and the rest I16 (Y2 blocks far apart)."""
    rng = np.random.RandomState(seed)
    nmb = mbw * mbh
    mags = rng.choice(MAGS, size=(batch, nmb, 25, 16))
    mags[rng.rand(batch, nmb, 25) < 0.3] = 0   # empty blocks
    lv = mags * rng.choice([-1, 1], size=mags.shape)
    lv[rng.rand(batch, nmb) < 0.15] = 0        # skipped MBs
    if skip_all:
        lv[:] = 0
    if clip:
        lv = np.clip(lv, -2047, 2047)
    lv = lv.astype(np.int16)
    modes = [4] if all_b else [0, 1, 2, 3, 4, 4]
    luma_mode = rng.choice(modes, size=(batch, nmb)).astype(np.uint8)
    if b_share:
        luma_mode = np.where(rng.rand(batch, nmb) < b_share, 4, luma_mode % 4).astype(np.uint8)
    y2 = lv[:, :, 0].copy()
    y2[luma_mode == 4] = 0
    y = lv[:, :, 1:17].copy()
    y[..., 0] = np.where((luma_mode != 4)[..., None], 0, y[..., 0])  # I16: the DC rides in Y2
    return dict(luma_mode=luma_mode, y2_levels=y2, y_levels=y, uv_levels=lv[:, :, 17:].copy())


def planes(kind: str, batch: int, mbw: int, mbh: int, seed: int):
    """(y [B, mbh*16, mbw*16], u, v [B, mbh*8, mbw*8]) uint8 of a "flat"
    frame (one value a plane and image), "noise", or "mixed" (flat MBs
    beside noise MBs)."""
    rng = np.random.RandomState(seed)
    shapes = [(batch, mbh * 16, mbw * 16), (batch, mbh * 8, mbw * 8), (batch, mbh * 8, mbw * 8)]
    out = []
    for shape in shapes:
        noise = rng.randint(0, 256, shape).astype(np.uint8)
        flat = np.broadcast_to(rng.randint(0, 256, (batch, 1, 1)), shape).astype(np.uint8)
        if kind == "flat":
            out.append(np.ascontiguousarray(flat))
        elif kind == "noise":
            out.append(noise)
        else:
            size = shape[1] // mbh
            keep = rng.rand(batch, mbh, mbw) < 0.5
            sel = keep.repeat(size, 1).repeat(size, 2)
            out.append(np.where(sel, noise, flat).astype(np.uint8))
    return tuple(out)

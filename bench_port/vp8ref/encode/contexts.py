"""Frozen copy of the plain code of `webp_tpu_torch/encode/contexts.py`, the
benchmark's reference; it imports nothing of the port.

Token contexts of a frame's level blocks (host, numpy).

The decoder's complexity chains (left/top nonzero flags per 4x4 block) are
pure functions of the quantized levels, so the whole frame's contexts come
from shifted boolean grids.  Y2 contexts skip over B-predicted MBs (which
carry no Y2 block) by a forward fill.  The same rules as
`webp_tpu/encode/contexts.py`; kernel K6 computes them on the card.
"""

from __future__ import annotations

import numpy as np


def _ffill_exclusive(arr):
    """Per column: last non-(-1) value strictly above, else -1. arr [H, W]."""
    out = np.vstack([np.full((1, arr.shape[1]), -1, arr.dtype), arr[:-1]])
    for i in range(1, out.shape[0]):
        out[i] = np.where(out[i] == -1, out[i - 1], out[i])
    return out


def _grid_ctx(nz, mbw: int, mbh: int, sub: int):
    """[nmb, sub*sub] nonzero flags -> top + left neighbour counts."""
    g = nz.reshape(mbh, mbw, sub, sub).transpose(0, 2, 1, 3).reshape(mbh * sub, mbw * sub)
    g = g.astype(np.int32)
    top = np.vstack([np.zeros((1, mbw * sub), np.int32), g[:-1]])
    left = np.hstack([np.zeros((mbh * sub, 1), np.int32), g[:, :-1]])
    return (top + left).reshape(mbh, sub, mbw, sub).transpose(0, 2, 1, 3).reshape(-1, sub * sub)


def compute_contexts(luma_mode, y2_levels, y_levels, uv_levels, mbw: int, mbh: int):
    """Initial contexts of every block: y2_ctx [nmb], y_ctx [nmb, 16],
    uv_ctx [nmb, 8], and has_y2 [nmb] (the MB is not B-predicted)."""
    has_y2 = luma_mode != 4
    y_nz = np.where(has_y2[:, None], (y_levels[:, :, 1:] != 0).any(axis=2),
                    (y_levels != 0).any(axis=2))
    uv_nz = (uv_levels != 0).any(axis=2)
    y2_nz = (y2_levels != 0).any(axis=1) & has_y2

    uv_ctx = np.concatenate([_grid_ctx(uv_nz[:, :4], mbw, mbh, 2),
                             _grid_ctx(uv_nz[:, 4:], mbw, mbh, 2)], axis=1)
    vals = np.where(has_y2, y2_nz.astype(np.int32), -1).reshape(mbh, mbw)
    top_f = _ffill_exclusive(vals)
    left_f = _ffill_exclusive(vals.T).T
    y2_ctx = (np.maximum(top_f, 0) + np.maximum(left_f, 0)).reshape(-1)
    return dict(y2_ctx=y2_ctx.astype(np.int32), y_ctx=_grid_ctx(y_nz, mbw, mbh, 4),
                uv_ctx=uv_ctx, has_y2=has_y2)

"""Per-MB sparse level format used by the decode upload.

Per image (flat level vector of nmb*S slots, S = 400 per macroblock):
  bitmap: uint8 [nmb*S/8]     one bit per slot, np.packbits order (MSB first)
  vals:   int8  [nmb, cap_mb] MB m's nonzero levels in slot order, zero padded

`host_pack_levels_mb` is the numpy host pack of `webp_tpu/ops/sparse.py`,
copied here because that module imports jax.  `expand_levels_mb` is the plain
torch expansion; the CUDA kernel in `csrc/residual.cu` expands the same format
in shared memory.
"""

from __future__ import annotations

import numpy as np
import torch


def host_pack_levels_mb(flat_i8: np.ndarray, nmb: int, S: int, cap_mb: int):
    """[nmb*S] int8 -> (bitmap uint8 [nmb*S/8], vals int8 [nmb, cap_mb], ok).

    MB m's nonzeros occupy vals[m, :count_m] in slot order.  ok=False when
    any MB exceeds cap_mb (the caller falls back to the dense path).
    """
    lv2 = flat_i8.reshape(nmb, S)
    mask = lv2 != 0
    bitmap = np.packbits(mask)
    counts = mask.sum(1)
    if counts.max(initial=0) > cap_mb:
        return bitmap, None, False
    rows, cols = np.nonzero(mask)  # sorted by (row, col)
    row_start = np.concatenate([[0], np.cumsum(counts[:-1])])
    ranks = np.arange(len(rows)) - row_start[rows]
    vals = np.zeros((nmb, cap_mb), np.int8)
    vals[rows, ranks] = lv2[rows, cols]
    return bitmap, vals, True


_BIT_SHIFTS = (7, 6, 5, 4, 3, 2, 1, 0)  # np.packbits order: MSB first


def expand_levels_mb(bitmap: torch.Tensor, vals: torch.Tensor, nmb: int, S: int) -> torch.Tensor:
    """(bitmap uint8 [B, nmb*S/8], vals int8 [B, nmb, cap_mb]) -> int16 [B, nmb, S].

    Slot j of MB m receives vals[m, rank] where rank counts the set bits of
    MB m before j; a rank at or past cap_mb yields 0 (as the one-hot
    expansion of the JAX package does).
    """
    B = bitmap.shape[0]
    cap = vals.shape[-1]
    shifts = torch.tensor(_BIT_SHIFTS, dtype=torch.int32, device=bitmap.device)
    bits = (bitmap.to(torch.int32)[..., None] >> shifts) & 1
    mask = bits.reshape(B, nmb, S) != 0
    rank = torch.cumsum(mask.to(torch.int32), dim=-1) - 1
    picked = torch.gather(vals.to(torch.int16), 2, rank.clamp(0, cap - 1).to(torch.int64))
    return torch.where(mask & (rank < cap), picked, torch.zeros_like(picked))

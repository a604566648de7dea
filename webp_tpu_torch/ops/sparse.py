"""Per-MB sparse level format of the decode upload and the encode wire.

Per image (flat level vector of nmb*S slots, S = 400 per macroblock):
  bitmap: uint8 [nmb*S/8]     one bit per slot, np.packbits order (MSB first)
  vals:   int8  [nmb, cap_mb] MB m's nonzero levels in slot order, zero padded

`host_pack_levels_mb` and `host_expand_levels_mb` are the numpy host pack and
expansion of `webp_tpu/ops/sparse.py`, copied here because that module
imports jax.  `expand_levels_mb` is the plain torch expansion; the CUDA
kernel in `csrc/residual.cu` expands the same format in shared memory.

Kernel K19, `pack_levels_mb`, is the device pack of the encode wire
(`ops/wire.py`): it replaces `webp_tpu/ops/sparse.py:73`
`device_pack_levels_mb`, jitted as `webp_tpu/ops/encode_wavefront2.py:1113`
`_pack_levels_stage`.  The JAX form compacts with a float32 one-hot matmul
per MB; the CUDA kernel (`csrc/wire.cu`) ranks each MB's nonzeros with warp
ballots, in integers.  `pack_levels_mb_plain` is its torch twin, run for CPU
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build


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


def host_expand_levels_mb(bitmap: np.ndarray, vals: np.ndarray, nmb: int, S: int) -> np.ndarray:
    """(bitmap uint8 [nmb*S/8], vals int8 [nmb, cap_mb]) -> dense int8 [nmb, S],
    the inverse of `host_pack_levels_mb` (ValueError when an MB holds more
    nonzeros than cap_mb: the pack was cut, the caller needs the dense row)."""
    cap_mb = vals.shape[1]
    flat_idx = np.flatnonzero(np.unpackbits(bitmap)[: nmb * S])  # sorted, so grouped by MB
    mb_idx = flat_idx // S
    counts = np.bincount(mb_idx, minlength=nmb)
    if counts.max(initial=0) > cap_mb:
        raise ValueError("per-MB nonzero count exceeds the sparse cap")
    row_start = np.concatenate([[0], np.cumsum(counts[:-1])])
    ranks = np.arange(len(flat_idx)) - row_start[mb_idx]
    out = np.zeros(nmb * S, np.int8)
    out[flat_idx] = vals.reshape(-1)[mb_idx * cap_mb + ranks]
    return out.reshape(nmb, S)


_BIT_SHIFTS = (7, 6, 5, 4, 3, 2, 1, 0)  # np.packbits order: MSB first


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """bool [..., 8n] -> uint8 [..., n] in np.packbits order."""
    w = torch.tensor([1 << s for s in _BIT_SHIFTS], dtype=torch.int32, device=mask.device)
    m8 = mask.reshape(*mask.shape[:-1], -1, 8).to(torch.int32)
    return (m8 * w).sum(-1).to(torch.uint8)


def compact(mask: torch.Tensor, cap: int, *fields: torch.Tensor):
    """Along the last axis, each field's entries where `mask` holds, in slot
    order, zero padded to `cap` (entries past `cap` dropped), and whether
    more than `cap` were masked: ([..., cap] per field, over [...] bool).
    Integer ranks: exact at any position."""
    rank = torch.cumsum(mask.to(torch.int32), dim=-1) - 1
    keep = mask & (rank < cap)
    idx = torch.where(keep, rank, cap).to(torch.int64)  # slot `cap` takes the rest
    outs = []
    for f in fields:
        out = f.new_zeros((*f.shape[:-1], cap + 1))
        out.scatter_(-1, idx, torch.where(keep, f, torch.zeros_like(f)))
        outs.append(out[..., :cap])
    return outs, rank[..., -1] + 1 > cap


def pack_levels_mb_plain(lv8: torch.Tensor, cap_mb: int):
    """Torch twin of kernel K19 (any device)."""
    B, nmb, S = lv8.shape
    mask = lv8 != 0
    (vals,), over = compact(mask, cap_mb, lv8)
    return pack_bits(mask.reshape(B, nmb * S)), vals, over.any(-1)


def pack_levels_mb(lv8: torch.Tensor, cap_mb: int):
    """int8 levels [B, nmb, 400] -> (bitmap uint8 [B, nmb*50], vals int8
    [B, nmb, cap_mb], overflow bool [B]): vals[b, m, k] is the (k+1)-th
    nonzero of MB m in slot order, zero past its count; nonzeros beyond
    cap_mb are dropped and set overflow[b]."""
    if lv8.dtype != torch.int8 or lv8.dim() != 3 or lv8.shape[-1] != 400:
        raise ValueError(f"lv8 must be int8 [B, nmb, 400], got {lv8.dtype} {tuple(lv8.shape)}")
    if not 0 < cap_mb <= 400:
        raise ValueError(f"cap_mb must be in 1..400, got {cap_mb}")
    if lv8.device.type == "cpu":
        return pack_levels_mb_plain(lv8, cap_mb)
    return _pack_levels_kernel(lv8, cap_mb)


def _pack_levels_kernel(lv8: torch.Tensor, cap_mb: int):
    dev = lv8.device
    B, nmb, S = lv8.shape
    bitmap = torch.empty((B, nmb * S // 8), dtype=torch.uint8, device=dev)
    vals = torch.empty((B, nmb, cap_mb), dtype=torch.int8, device=dev)
    over = torch.zeros(B, dtype=torch.bool, device=dev)
    _build.launch("pack_levels", "webp_pack_levels", dev,
                  _build.dense(lv8, torch.int8, (B, nmb, S)), nmb, B, cap_mb,
                  bitmap.data_ptr(), vals.data_ptr(), over.data_ptr())
    return bitmap, vals, over


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

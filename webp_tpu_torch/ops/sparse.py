"""Per-MB sparse level format of the decode upload and the encode wire.

Per image (flat level vector of nmb*S slots, S = 400 per macroblock):
  bitmap: uint8 [nmb*S/8]     one bit per slot, np.packbits order (MSB first)
  vals:   int8  [nmb, cap_mb] MB m's nonzero levels in slot order, zero padded
or, in the image-flat form, vals int8 [cap] holding the image's nonzero
levels in slot order, zero padded (`cap_for`).

`cap_for`, `host_pack_levels`, `host_expand_levels`, `host_pack_levels_mb`
and `host_expand_levels_mb` are the numpy host helpers of
`webp_tpu/ops/sparse.py`, copied here because that module imports jax.  `expand_levels_mb` is the plain torch expansion; the CUDA
kernel in `csrc/residual.cu` expands the same format in shared memory.

Kernel K19, `pack_levels_mb`, is the device pack of the encode wire
(`ops/wire.py`): it replaces `webp_tpu/ops/sparse.py:73`
`device_pack_levels_mb`, jitted as `webp_tpu/ops/encode_wavefront2.py:1113`
`_pack_levels_stage`.  The JAX form compacts with a float32 one-hot matmul
per MB; the CUDA kernel (`csrc/wire.cu`) gives each lane of an MB's warp a
run of 8 slots and ranks the nonzeros by a shuffle scan of the runs' counts,
in integers.  `pack_levels_mb_plain` is its torch twin, run for CPU
tensors.

Kernels K21 `pack_levels` and K22 `expand_levels` (`csrc/sparse.cu`) are the
image-flat pack and expansion: they replace `webp_tpu/ops/sparse.py:42`
`device_pack_levels` (a cumsum and a searchsorted per value) and `:110`
`device_expand_levels` (a cumsum and a take_along_axis), bit for bit.  Each
is one launch over tiles of FLAT_TILE slots taken by a per-image ticket; a
tile finds its offset by a decoupled look-back over per-tile status words.
K22 is a CTA per tile; K21 runs as many CTAs an image as the card holds
at once, each taking tiles, then parts of the zeros past the image's
count, until the image's tickets run out.  No
path of either package calls them; `chip_smoke.py` holds them to their
twins `pack_levels_plain` and `expand_levels_plain`.  The flat expansion
differs from the host one on an image over its cap: a set slot of rank r
takes vals[min(r, cap - 1)], where `host_expand_levels` raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build


def cap_for(nmb: int) -> int:
    """Static nonzero budget of the image-flat form: 128 level slots per MB."""
    return nmb * 128


def host_pack_levels(flat_i8: np.ndarray, cap: int):
    """[N] int8 -> (bitmap, vals, ok). ok=False when nonzeros exceed cap."""
    mask = flat_i8 != 0
    bitmap = np.packbits(mask)
    nz = flat_i8[mask]
    if len(nz) > cap:
        return bitmap, None, False
    vals = np.zeros(cap, np.int8)
    vals[: len(nz)] = nz
    return bitmap, vals, True


def host_expand_levels(bitmap: np.ndarray, vals: np.ndarray, n: int) -> np.ndarray:
    """(bitmap uint8 [n/8], vals int8 [cap]) -> dense int8 [n] (raises when
    the bitmap holds more than cap nonzeros)."""
    bits = np.unpackbits(bitmap)[:n]
    out = np.zeros(n, np.int8)
    idx = np.nonzero(bits)[0]
    out[idx] = vals[: len(idx)]
    return out


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
                  _build.aligned(_build.dense(lv8, torch.int8, (B, nmb, S)), 8, "lv8"), nmb, B,
                  cap_mb, bitmap.data_ptr(), vals.data_ptr(), over.data_ptr())
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


def pack_levels_plain(flat_i8: torch.Tensor, cap: int):
    """Torch twin of kernel K21 (any device)."""
    mask = flat_i8 != 0
    (vals,), over = compact(mask, cap, flat_i8)
    return pack_bits(mask), vals, over


def pack_levels(flat_i8: torch.Tensor, cap: int):
    """int8 levels [B, N] (N % 8 == 0) -> (bitmap uint8 [B, N/8], vals int8
    [B, cap], overflow bool [B]): vals[b, k] is the (k+1)-th nonzero of image
    b in slot order, zero past its count; nonzeros beyond `cap` are dropped
    and set overflow[b] (a count of exactly `cap` does not)."""
    if flat_i8.dtype != torch.int8 or flat_i8.dim() != 2:
        raise ValueError(f"levels must be int8 [B, N], got {flat_i8.dtype} {tuple(flat_i8.shape)}")
    B, N = flat_i8.shape
    if N % 8 != 0 or not 0 < N < 2**31:
        raise ValueError(f"N must be a positive multiple of 8 below 2^31, got {N}")
    if not 0 <= cap < 2**31:
        raise ValueError(f"cap must be in 0..2^31-1, got {cap}")
    if flat_i8.device.type == "cpu":
        return pack_levels_plain(flat_i8, cap)
    return _pack_flat_kernel(flat_i8, cap)


# Slots of a K21 or K22 CTA's tile (`csrc/sparse.cu` kTileSlots): 32 a thread.
FLAT_TILE = 8192


def _flat_state(name: str, B: int, slots: int, dev) -> torch.Tensor:
    """Each image's ticket and done count, then its tiles' status words:
    the kernel leaves them zero."""
    return _build.kept_zeroed(name, B * (1 + -(-slots // FLAT_TILE)), torch.int64, dev)


def _pack_flat_kernel(flat_i8: torch.Tensor, cap: int):
    dev = flat_i8.device
    B, N = flat_i8.shape
    bitmap = torch.empty((B, N // 8), dtype=torch.uint8, device=dev)
    vals = torch.empty((B, cap), dtype=torch.int8, device=dev)  # the kernel writes the pad
    over = torch.empty(B, dtype=torch.bool, device=dev)
    _build.launch("pack_flat", "webp_pack_flat", dev,
                  _build.dense(flat_i8, torch.int8, (B, N)), N, B, cap,
                  _flat_state("pack_flat", B, N, dev).data_ptr(),
                  bitmap.data_ptr(), vals.data_ptr(), over.data_ptr())
    return bitmap, vals, over


def expand_levels_plain(bitmap: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """Torch twin of kernel K22 (any device)."""
    B = bitmap.shape[0]
    cap = vals.shape[-1]
    shifts = torch.tensor(_BIT_SHIFTS, dtype=torch.int32, device=bitmap.device)
    mask = (((bitmap.to(torch.int32)[..., None] >> shifts) & 1).reshape(B, -1)[:, :n]) != 0
    rank = torch.cumsum(mask.to(torch.int32), dim=-1) - 1
    picked = torch.gather(vals, 1, rank.clamp(0, cap - 1).to(torch.int64))
    return torch.where(mask, picked, torch.zeros_like(picked))


def expand_levels(bitmap: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """(bitmap uint8 [B, nb], vals int8 [B, cap]) -> int8 [B, n], n <= 8 nb:
    of the bitmap's first n bits, a set slot of image-wide rank r takes
    vals[b, min(r, cap - 1)] (past the cap the last value repeats), an unset
    slot 0."""
    if bitmap.dtype != torch.uint8 or bitmap.dim() != 2:
        raise ValueError(f"bitmap must be uint8 [B, nb], got {bitmap.dtype} {tuple(bitmap.shape)}")
    B, nb = bitmap.shape
    if vals.dtype != torch.int8 or vals.dim() != 2 or vals.shape[0] != B or vals.shape[1] < 1:
        raise ValueError(f"vals must be int8 [{B}, cap >= 1], got {vals.dtype} {tuple(vals.shape)}")
    if not 0 < n <= 8 * nb or n >= 2**31:
        raise ValueError(f"n must be in 1..{8 * nb} (and below 2^31), got {n}")
    _build.same_device(bitmap, vals)
    if bitmap.device.type == "cpu":
        return expand_levels_plain(bitmap, vals, n)
    return _expand_flat_kernel(bitmap, vals, n)


def _expand_flat_kernel(bitmap: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    dev = bitmap.device
    B, nb = bitmap.shape
    cap = vals.shape[1]
    out = torch.empty((B, n), dtype=torch.int8, device=dev)
    _build.launch("expand_flat", "webp_expand_flat", dev,
                  _build.dense(bitmap, torch.uint8, (B, nb)), nb,
                  _build.dense(vals, torch.int8, (B, cap)), cap, n, B,
                  _flat_state("expand_flat", B, n, dev).data_ptr(), out.data_ptr())
    return out

"""Frozen copy of the plain code of `webp_tpu_torch/ops/enc_costs.py`, the
benchmark's reference; it imports nothing of the port.

Rate of quantized level blocks (GetResidualCost), the encode's rate model.

Plain torch twin of `webp_tpu/ops/encode_wavefront2.py:186`
`residual_costs_par`, evaluated inside kernel K5 (`csrc/enc.cu`,
`residual_cost`).  The JAX form rebuilds table lookups from one-hot matmuls
and bit arithmetic because XLA:TPU gathers per lane slowly; here the costs
are plain lookups: the token-class cost `cls_cost[ctype][pos][ctx][class]`
of each image and the fixed sign + extra-bits cost `VP8_LEVEL_FIXED_COSTS`
(which carries libwebp's deviations at levels 9 and 10 itself).
"""

from __future__ import annotations

import torch

from .. import _consts
from ..encode import tables as ET

# Token class of min(|v|, 67): the number of these thresholds it reaches.
CLS_THRESH = (1, 2, 3, 4, 5, 7, 11, 19, 35, 67)


def lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [B, K] per image, idx [n, B, ...] -> table[b][idx] per lane."""
    n, B = idx.shape[:2]
    flat = idx.reshape(n, B, -1).long()
    out = torch.gather(table[None].expand(n, B, table.shape[-1]), 2, flat)
    return out.reshape(idx.shape)


def token_class(v: torch.Tensor) -> torch.Tensor:
    return sum((v >= t).to(torch.int32) for t in CLS_THRESH)


def residual_costs(levels: torch.Tensor, ctype: int, first: int, ctx0, tbl) -> torch.Tensor:
    """Rate in 1/256 bits of zigzag level blocks [n, B, ..., 16] (lanes n,
    images B) coded as token type `ctype` from position `first` with initial
    context `ctx0` (an int or a tensor broadcastable to the blocks), under
    the images' tables `tbl` (`EncTables`) -> int32 [n, B, ...]."""
    v = levels.to(torch.int32).abs()
    lead = levels.shape[:-1]
    n_idx = torch.arange(16, dtype=torch.int32, device=v.device)
    nz = v != 0
    any_nz = nz[..., first:].any(-1)
    last = torch.where(nz, n_idx, -1).amax(-1)  # -1 when all-zero

    ctx0b = torch.as_tensor(ctx0, dtype=torch.int32, device=v.device).expand(lead)
    ctx = torch.cat([ctx0b[..., None], v[..., :-1].clamp_max(2)], dim=-1)
    if first:
        ctx[..., first] = ctx0b
    cls = token_class(v.clamp_max(67))
    terms = lookup(tbl.cls_cost[:, ctype].reshape(tbl.batch, -1), (n_idx * 3 + ctx) * 11 + cls)
    fixed = _consts.device_constant("level_fixed_costs", ET.VP8_LEVEL_FIXED_COSTS, v.device)
    terms = terms + fixed[v.clamp_max(2047).long()]
    active = (n_idx >= first) & (n_idx <= last[..., None])
    cost = torch.where(active, terms, 0).sum(-1, dtype=torch.int32)
    init = lookup(tbl.init_cost[:, ctype, first, 0:1], torch.zeros_like(ctx0b))
    cost = cost + torch.where(ctx0b == 0, init, 0)

    eob = tbl.eob_cost[:, ctype].reshape(tbl.batch, -1)
    lastv1 = ((v == 1) & (n_idx == last[..., None])).any(-1)
    last_ctx = torch.where(lastv1, 1, 2)
    eobc = lookup(eob, (last + 1).clamp_max(15) * 3 + last_ctx)
    cost = torch.where(any_nz & (last < 15), cost + eobc, cost)
    empty = lookup(eob, first * 3 + ctx0b)
    return torch.where(any_nz, cost, empty)

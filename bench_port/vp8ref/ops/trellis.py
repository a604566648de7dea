"""Frozen copy of the plain code of `webp_tpu_torch/ops/trellis.py`, the
benchmark's reference; it imports nothing of the port.

Trellis quantization: rate-distortion optimal levels of 4x4 blocks.

Plain torch twin of `webp_tpu/ops/trellis2.py:110` `trellis_par` and
`:325` `trellis_spec3` (libwebp VP8TrellisQuantizeBlock), which kernel K5
evaluates in `csrc/trellis.cuh`.  Over the zigzag positions from `first`
to the last significant one (+1), each position has two candidate levels,
level0 = (|c| + sharpen) * iq >> 17 and level0 + 1 (the latter only below
the biased threshold level), and each node keeps the cheaper of its two
predecessors, whose level sets the token context of its rate; the EOB
after every nonzero node is scored, and the best path is unwound from the
cheapest terminal.  Scores are native int64: the JAX package carries them
as (hi int32, lo uint32) pairs because XLA:TPU has no 64-bit integers, and
its level fixed cost is an arithmetic rebuild of the table looked up here.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _consts
from ..encode import tables as ET
from .enc_costs import token_class
from .enc_params import ZZ

BIG = 1 << 62  # score of an invalid node
_TBIAS = ((0x80 << 17) + 128) >> 8  # rounding of the threshold level
_W_TRELLIS_ZZ = np.asarray(ET.VP8_WEIGHT_TRELLIS, np.int64)[ZZ]


def _pick(table, idx):
    """table [..., K] broadcast against idx [...] -> table[..., idx]."""
    shape = torch.broadcast_shapes(table.shape[:-1], idx.shape)
    return torch.gather(table.expand(*shape, table.shape[-1]), -1,
                        idx.expand(shape)[..., None].long())[..., 0]


def trellis_par(coeffs_raster, q, iq, sharpen_zz, lam, first: int, ctx0, cls_cost, eob_cost,
                init_cost):
    """RD-optimal levels of [..., 16] raster-order coefficient blocks.

    q/iq/sharpen_zz: zigzag-order vectors broadcastable to [..., 16]; lam and
    ctx0 broadcastable to [...]; cls_cost [..., 16, 3, 11], eob_cost and
    init_cost [..., 16, 3]: the EncTables fields of the blocks' token type,
    broadcastable against the blocks' leading dims.  Returns (levels_zz
    [..., 16] int32, has_nz [...] bool)."""
    dev = coeffs_raster.device
    c = coeffs_raster[..., torch.from_numpy(ZZ).to(dev)].to(torch.int64)
    lam = torch.as_tensor(lam, device=dev).to(torch.int64)
    ctx0 = torch.as_tensor(ctx0, device=dev).to(torch.int64)
    lead = torch.broadcast_shapes(c.shape[:-1], lam.shape, ctx0.shape)
    c = c.expand(*lead, 16)
    q, iq, sharpen = (torch.as_tensor(t, device=dev).to(torch.int64).expand(c.shape)
                      for t in (q, iq, sharpen_zz))
    lam, ctx0 = lam.expand(lead), ctx0.expand(lead)
    n_idx = torch.arange(16, device=dev)

    sign = c < 0
    a = c.abs() + sharpen
    sig = (c * c > ((q[..., 1] * q[..., 1]) // 4)[..., None]) & (n_idx >= first)
    last = torch.where(sig.any(-1), torch.where(sig, n_idx, -1).amax(-1), first - 1)
    last = (last + 1).clamp_max(15)
    level0 = ((a * iq) >> 17).clamp_max(2047)
    tlevel = ((a * iq + _TBIAS) >> 17).clamp_max(2047)

    fixed = _consts.device_constant("level_fixed_costs", ET.VP8_LEVEL_FIXED_COSTS, dev)
    cls_cost = cls_cost.to(torch.int64)
    eob_cost = eob_cost.to(torch.int64)
    best = lam * _pick(eob_cost[..., first, :], ctx0)   # skip: EOB at `first`
    best_n = torch.full(lead, -1, dtype=torch.int64, device=dev)
    best_d = torch.zeros(lead, dtype=torch.int64, device=dev)
    init_rate = torch.where(ctx0 == 0, init_cost[..., first, 0].to(torch.int64), 0)
    score = [lam * init_rate] * 2                          # per delta of the previous node
    pctx = [ctx0] * 2
    prev = torch.zeros((16, *lead, 2), dtype=torch.int64, device=dev)

    for n in range(first, 16):
        active = n <= last
        new_score, new_ctx = [], []
        for delta in (0, 1):
            lvl = level0[..., n] + delta
            valid = active & (lvl <= tlevel[..., n])
            err = a[..., n] - lvl * q[..., n]
            base = 256 * int(_W_TRELLIS_ZZ[n]) * (err * err - a[..., n] * a[..., n])
            lvf = fixed[lvl.clamp_max(2047)].to(torch.int64) + torch.where(lvl > 0, 256, 0)
            cls = token_class(lvl.clamp_max(67))
            cost = [score[p] + lam * (_pick(cls_cost[..., n, :, :].flatten(-2), pctx[p] * 11 + cls)
                                      + lvf) for p in (0, 1)]
            take1 = cost[1] < cost[0]
            bs = torch.where(take1, cost[1], cost[0]) + base
            prev[n, ..., delta] = take1.to(torch.int64)
            new_score.append(torch.where(valid, bs, BIG))
            new_ctx.append(lvl.clamp_max(2))
            eob = (_pick(eob_cost[..., n + 1, :], lvl.clamp_max(2)) if n < 15
                   else torch.zeros_like(lvl))
            term = bs + lam * eob
            better = valid & (lvl != 0) & (term < best)
            best = torch.where(better, term, best)
            best_n = torch.where(better, n, best_n)
            best_d = torch.where(better, delta, best_d)
        score, pctx = new_score, new_ctx

    out = torch.zeros((*lead, 16), dtype=torch.int64, device=dev)
    cur = best_d
    for n in range(15, first - 1, -1):
        sel = best_n >= n
        lvl = level0[..., n] + cur
        out[..., n] = torch.where(sel, torch.where(sign[..., n], -lvl, lvl), 0)
        cur = torch.where(sel, torch.gather(prev[n], -1, cur[..., None])[..., 0], cur)
    return out.to(torch.int32), (out[..., first:] != 0).any(-1)


def trellis_spec3(coeffs_raster, q, iq, sharpen_zz, lam, first: int, cls_cost, eob_cost,
                  init_cost):
    """`trellis_par` under each entry context 0, 1, 2: (levels [..., 3, 16],
    has_nz [..., 3]).  The arguments broadcast as in `trellis_par`; a
    context axis goes in before the blocks' last axis."""
    dev = coeffs_raster.device

    def ctx_axis(t):
        return torch.as_tensor(t, device=dev)[..., None, :]

    return trellis_par(coeffs_raster[..., None, :], ctx_axis(q), ctx_axis(iq),
                       ctx_axis(sharpen_zz), torch.as_tensor(lam, device=dev)[..., None], first,
                       torch.arange(3, device=dev), cls_cost[..., None, :, :, :],
                       eob_cost[..., None, :, :], init_cost[..., None, :, :])

"""Frozen copy of the plain code of `webp_tpu_torch/ops/token_stats.py`, the
benchmark's reference; it imports nothing of the port.

Kernel K6: per-image token statistics of the pass-1 levels, on the card.

Replaces `webp_tpu/ops/token_stats.py:183` `token_stats_device` (with
`compute_contexts_j` :49, `_block_events` :90 and `_accumulate` :161).  The
two-pass flow needs only the (total, ones) counts per token-tree node,
[B, 4, 8, 3, 11] int32 of a few KB, so pass 1's levels never leave the
card.  The counts are those of `webp_tpu/encode/costs.py`
`ProbaStats.record_blocks` over the token stream, and of the host C++
`vp8_token_stats`.

`token_stats_plain` is the plain torch form.  It follows the JAX form:
contexts from shifted nonzero grids (a forward fill for Y2, whose context
skips MBs without a Y2 block), then per-(block, position) node events in
closed form, summed by band.
"""

from __future__ import annotations

import numpy as np
import torch

from ..encode import tables as ET

BANDS = np.array(ET.VP8_ENC_BANDS[:16], np.int64)
N_COUNTERS = 4 * 8 * 3 * 11
EOB = 11         # the event code after the 11 token classes


def skip_flags(y2_levels, y_levels, uv_levels):
    """[B, nmb] bool: the MB carries no nonzero level."""
    return ((y_levels == 0).all(-1).all(-1) & (uv_levels == 0).all(-1).all(-1)
            & (y2_levels == 0).all(-1))


def _ffill_exclusive(vals):
    """Per column of [B, H, W] values in {-1, 0, 1}: the last value >= 0
    strictly above, else -1 (a running max of row * 2 + value)."""
    H = vals.shape[-2]
    rows = torch.arange(H, device=vals.device)[:, None]
    key = torch.where(vals >= 0, rows * 2 + vals, -1)
    run = torch.cummax(key, dim=-2).values
    shifted = torch.cat([torch.full_like(run[..., :1, :], -1), run[..., :-1, :]], dim=-2)
    return torch.where(shifted >= 0, shifted & 1, -1)


def compute_contexts(luma_mode, y2_levels, y_levels, uv_levels, mbw: int, mbh: int):
    """Initial contexts [B, nmb] (Y2), [B, nmb, 16] (Y), [B, nmb, 8] (UV)."""
    B = luma_mode.shape[0]
    nmb = mbw * mbh
    has_y2 = luma_mode != 4
    y_nz = torch.where(has_y2[..., None], (y_levels[..., 1:] != 0).any(-1), (y_levels != 0).any(-1))
    uv_nz = (uv_levels != 0).any(-1)
    y2_nz = (y2_levels != 0).any(-1) & has_y2

    def grid_ctx(nz, sub: int):
        g = nz.reshape(B, mbh, mbw, sub, sub).transpose(2, 3).reshape(B, mbh * sub, mbw * sub)
        g = g.to(torch.int32)
        top = torch.cat([torch.zeros_like(g[:, :1]), g[:, :-1]], dim=1)
        left = torch.cat([torch.zeros_like(g[:, :, :1]), g[:, :, :-1]], dim=2)
        return (top + left).reshape(B, mbh, sub, mbw, sub).transpose(2, 3).reshape(B, nmb, sub * sub)

    vals = torch.where(has_y2, y2_nz.to(torch.int64), -1).reshape(B, mbh, mbw)
    top_f = _ffill_exclusive(vals)
    left_f = _ffill_exclusive(vals.transpose(-1, -2)).transpose(-1, -2)
    y2_ctx = (top_f.clamp(min=0) + left_f.clamp(min=0)).reshape(B, nmb)
    uv_ctx = torch.cat([grid_ctx(uv_nz[..., :4], 2), grid_ctx(uv_nz[..., 4:], 2)], dim=-1)
    return y2_ctx, grid_ctx(y_nz, 4), uv_ctx


def _block_events(v, first, ctx0, active):
    """Node events of [N, 16] |level| blocks coded from `first` [N] with
    initial context ctx0 [N], where active [N]: (tot, ones) [N, 16, 11]
    counts by (position, node) and the context [N, 16] of each position.
    The trailing EOB is counted at position min(end, 15) (an empty block's
    at `first`)."""
    n_idx = torch.arange(16, device=v.device)
    nz = v != 0
    pos_ge_first = n_idx >= first[:, None]
    nz_eff = nz & pos_ge_first
    any_nz = nz_eff.any(-1)
    last = torch.where(nz_eff, n_idx, -1).amax(-1)
    end = torch.where(any_nz, last + 1, 0)
    act = active & any_nz
    in_run = pos_ge_first & (n_idx < end[:, None]) & act[:, None]

    prev_zero = torch.cat([torch.zeros_like(nz[:, :1]), ~nz[:, :-1]], dim=-1)
    at_first = n_idx == first[:, None]
    skip_eob = ~at_first & prev_zero
    vcl = v.clamp_max(67)
    is_zero = v == 0
    gt1 = ~is_zero & (v > 1)
    le4 = gt1 & (vcl <= 4)
    mid = gt1 & (vcl > 4) & (vcl <= 10)
    hi = gt1 & (vcl > 10)
    cat34 = hi & (vcl < 3 + (8 << 2))
    cat56 = hi & (vcl >= 3 + (8 << 2))
    events = [  # (mask, bit) per node
        (in_run & ~skip_eob, torch.ones_like(is_zero)),
        (in_run, ~is_zero),
        (in_run & ~is_zero, gt1),
        (in_run & gt1, vcl > 4),
        (in_run & le4, vcl > 2),
        (in_run & le4 & (vcl > 2), vcl == 4),
        (in_run & (mid | hi), hi),
        (in_run & mid, vcl > 6),
        (in_run & (cat34 | cat56), cat56),
        (in_run & cat34, vcl >= 3 + (8 << 1)),
        (in_run & cat56, vcl >= 3 + (8 << 3)),
    ]
    tot = torch.stack([m for m, _ in events], dim=-1).to(torch.int32)
    ones = torch.stack([m & b for m, b in events], dim=-1).to(torch.int32)
    eob_pos = torch.where(act, end.clamp_max(15), first)
    eob_on = active & torch.where(act, end < 16, True)
    tot[..., 0] += ((n_idx == eob_pos[:, None]) & eob_on[:, None]).to(torch.int32)
    vprev = torch.cat([torch.zeros_like(v[:, :1]), v[:, :-1]], dim=-1)
    ctx = torch.where(at_first, ctx0[:, None].expand_as(v), vprev.clamp_max(2))
    return tot, ones, ctx


def _accumulate(out, ctype: int, tot, ones, ctx):
    """Add [N, 16, 11] events at contexts [N, 16] into out [2, 4, 8, 3, 11]."""
    band = torch.from_numpy(BANDS).to(tot.device)
    idx = (band * 3 + ctx.long()).reshape(-1)  # [N * 16] -> band * 3 + ctx
    for j, arr in enumerate((tot, ones)):
        acc = torch.zeros((24, 11), dtype=torch.int32, device=tot.device)
        acc.index_add_(0, idx, arr.reshape(-1, 11))
        out[j, ctype] += acc.reshape(8, 3, 11)


def token_stats_plain(luma_mode, y2_levels, y_levels, uv_levels, skipped, mbw: int, mbh: int):
    """Torch twin of the K6 kernel (any device)."""
    B, nmb = luma_mode.shape
    y2_ctx, y_ctx, uv_ctx = compute_contexts(luma_mode, y2_levels, y_levels, uv_levels, mbw, mbh)
    has_y2 = luma_mode != 4
    act = ~skipped
    out = torch.zeros((2, B, 4, 8, 3, 11), dtype=torch.int32, device=luma_mode.device)
    for b in range(B):
        o = out[:, b]
        zeros = torch.zeros(nmb, dtype=torch.int64, device=luma_mode.device)
        _accumulate(o, 1, *_block_events(y2_levels[b].abs().to(torch.int32), zeros,
                                         y2_ctx[b], act[b] & has_y2[b]))
        vy = y_levels[b].abs().to(torch.int32).reshape(-1, 16)
        firsts = has_y2[b].to(torch.int64)[:, None].expand(nmb, 16).reshape(-1)
        for ctype, sel in ((0, has_y2[b]), (3, ~has_y2[b])):
            mask = (act[b] & sel)[:, None].expand(nmb, 16).reshape(-1)
            _accumulate(o, ctype, *_block_events(vy, firsts, y_ctx[b].reshape(-1), mask))
        vuv = uv_levels[b].abs().to(torch.int32).reshape(-1, 16)
        _accumulate(o, 2, *_block_events(vuv, torch.zeros(nmb * 8, dtype=torch.int64,
                                                          device=vuv.device),
                                         uv_ctx[b].reshape(-1),
                                         act[b][:, None].expand(nmb, 8).reshape(-1)))
    return out[0], out[1]


# ---- the kernel's schedule ---------------------------------------------------

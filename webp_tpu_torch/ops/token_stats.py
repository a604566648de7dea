"""Kernel K6: per-image token statistics of the pass-1 levels, on the card.

Replaces `webp_tpu/ops/token_stats.py:183` `token_stats_device` (with
`compute_contexts_j` :49, `_block_events` :90 and `_accumulate` :161).  The
two-pass flow needs only the (total, ones) counts per token-tree node,
[B, 4, 8, 3, 11] int32 of a few KB, so pass 1's levels never leave the
card.  The counts are those of `webp_tpu/encode/costs.py`
`ProbaStats.record_blocks` over the token stream, and of the host C++
`vp8_token_stats`.

`token_stats` launches the CUDA kernel (`csrc/token_stats.cu`) for CUDA
tensors and runs the plain torch twin `token_stats_plain` for CPU ones;
`token_stats_levels` does the same with the skip flags derived from the
levels (in the kernel, on the card).  The twin follows the JAX form:
contexts from shifted nonzero grids (a forward fill for Y2, whose context
skips MBs without a Y2 block), then per-(block, position) node events in
closed form, summed by band.  `token_stats_rows_plain` is the twin of the
kernel's schedule: CTAs of one MB row's run of MBs, Y2 contexts from a
chunked column scan and a row scan, one event code a (block, position),
and per-image counters finished by each image's last CTA.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..encode import tables as ET

BANDS = np.array(ET.VP8_ENC_BANDS[:16], np.int64)
# MBs a CTA of the kernel takes from one MB row (at most csrc/token_stats.cu's
# kSeg = 64): 24 was the fastest of 8-64 at batch 8 and 64, 768x512 on an
# H100 (tools/stats_split.py --segs).
SEG_MBS = 24
CHUNK_ROWS = 8   # rows of luma modes a CTA reads at a time for the Y2 context above (1-8)
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


def token_stats(luma_mode, y2_levels, y_levels, uv_levels, skipped, mbw: int, mbh: int):
    """(totals, ones) [B, 4, 8, 3, 11] int32 of the analysis arrays
    luma_mode [B, nmb] uint8, y2_levels [B, nmb, 16], y_levels
    [B, nmb, 16, 16], uv_levels [B, nmb, 8, 16] int16, skipped [B, nmb] bool."""
    dev = _build.same_device(luma_mode, y2_levels, y_levels, uv_levels, skipped)
    if dev.type == "cpu":
        return token_stats_plain(luma_mode, y2_levels, y_levels, uv_levels, skipped, mbw, mbh)
    return _token_stats_kernel(luma_mode, y2_levels, y_levels, uv_levels, skipped, mbw, mbh)


def token_stats_levels(luma_mode, y2_levels, y_levels, uv_levels, mbw: int, mbh: int):
    """`token_stats` with the skip flags of the levels themselves
    (`skip_flags`), which the kernel derives as it reads them."""
    dev = _build.same_device(luma_mode, y2_levels, y_levels, uv_levels)
    if dev.type == "cpu":
        return token_stats_plain(luma_mode, y2_levels, y_levels, uv_levels,
                                 skip_flags(y2_levels, y_levels, uv_levels), mbw, mbh)
    return _token_stats_kernel(luma_mode, y2_levels, y_levels, uv_levels, None, mbw, mbh)


def _token_stats_kernel(luma_mode, y2_levels, y_levels, uv_levels, skipped, mbw: int, mbh: int,
                        seg: int = SEG_MBS, chunk_rows: int = CHUNK_ROWS):
    """One launch of K6 with CTAs of `seg` MBs (1..64) of an MB row and
    column scans of `chunk_rows` rows (1..8); skipped None derives them."""
    dev = luma_mode.device
    B, nmb = luma_mode.shape
    if nmb != mbw * mbh:
        raise ValueError(f"{nmb} MBs for a {mbw}x{mbh} grid")
    out = torch.empty((2, B, 4, 8, 3, 11), dtype=torch.int32, device=dev)
    acc = _build.kept_zeroed("token_stats", B * (2 * N_COUNTERS + 1), torch.int32, dev)
    _build.launch(
        "token_stats", "webp_token_stats", dev,
        *_build.mb_field(luma_mode, B, nmb),
        *((None, 0) if skipped is None else _build.mb_field(skipped, B, nmb)),
        _build.dense(y2_levels, torch.int16, (B, nmb, 16)),
        _build.dense(y_levels, torch.int16, (B, nmb, 16, 16)),
        _build.dense(uv_levels, torch.int16, (B, nmb, 8, 16)),
        mbw, mbh, B, seg, chunk_rows, out.data_ptr(), acc.data_ptr(),
    )
    return out[0], out[1]


# ---- the kernel's schedule ---------------------------------------------------


def _nz_bits(blocks):
    """[..., 16] levels -> (any nonzero, any nonzero past the first) [...]."""
    nz = blocks != 0
    return nz.any(-1), nz[..., 1:].any(-1)


def _ctx_flags(blocks, has_y2):
    """[n, 25, 16] blocks (Y2, 16 Y, 8 UV) of MBs with has_y2 [n] -> the
    contexts' nonzero flags [n, 25]: Y2 only with a Y2 block, Y past the
    DC with one."""
    any_, ac = _nz_bits(blocks)
    flags = any_.clone()
    flags[:, 0] &= has_y2
    flags[:, 1:17] = torch.where(has_y2[:, None], ac[:, 1:17], any_[:, 1:17])
    return flags


def _mb_blocks(y2_levels, y_levels, uv_levels, b: int, ms):
    """[len(ms), 25, 16] int32 blocks of image b's MBs `ms`."""
    return torch.cat([y2_levels[b, ms][:, None], y_levels[b, ms], uv_levels[b, ms]],
                     dim=1).to(torch.int32)


BELOW = [13, 14, 15, 16, 19, 20, 23, 24]  # the blocks an MB's neighbour below reads


def _first_ctx(slot: int, i: int, mask, above: int, y2ctx) -> int:
    """The kernel's `first_ctx`: mask[i + 1] the MB's flag bits, mask[i] the
    left MB's, bit j of `above` the flag of the MB above's block BELOW[j]."""
    if slot == 0:
        return y2ctx[i]
    m, left_mb = mask[i + 1], mask[i]
    if slot <= 16:
        s = slot - 1
        sy, sx = s >> 2, s & 3
        top = (m >> (slot - 4)) & 1 if sy else (above >> sx) & 1
        left = (m >> (slot - 1)) & 1 if sx else (left_mb >> (4 + 4 * sy)) & 1
    else:
        s = slot - 17
        ch, qy, qx = s >> 2, (s >> 1) & 1, s & 1
        top = (m >> (slot - 2)) & 1 if qy else (above >> (4 + ch * 2 + qx)) & 1
        left = (m >> (slot - 1)) & 1 if qx else (left_mb >> (18 + ch * 4 + 2 * qy)) & 1
    return top + left


def _bits(flags) -> int:
    return sum(1 << k for k, f in enumerate(flags.tolist()) if f)


def _token_class(v):
    """Token class of |level| [...]: 0, 1, 2, 3, 4, 5-6, 7-10, 11-18, 19-34, 35-66, 67+."""
    edges = torch.tensor([1, 2, 3, 4, 5, 7, 11, 19, 35, 67], dtype=v.dtype, device=v.device)
    return torch.bucketize(v, edges, right=True)


def _nodes(fold):
    """Codes per (type, band, context) [4, 8, 3, 12] -> (totals, ones)
    [4, 8, 3, 11], as the kernel's flush folds them."""
    f = [fold[..., k] for k in range(12)]
    s2, s56, s78, s910 = f[2] + f[3] + f[4], f[5] + f[6], f[7] + f[8], f[9] + f[10]
    ge7 = s78 + s910
    ge5 = s56 + ge7
    ge2 = s2 + ge5
    all_ = f[0] + f[1] + ge2
    ctx = torch.arange(3)[None, None, :]
    band = torch.arange(8)[None, :, None]
    first_band = torch.tensor([1, 0, 0, 0])[:, None, None]
    skip = (ctx == 0) & (band != first_band)
    run = torch.where(skip, 0, all_)
    tot = [run + f[EOB], all_, all_ - f[0], ge2, s2, f[3] + f[4], ge5, s56, ge7, s78, s910]
    ones = [run, all_ - f[0], ge2, ge5, f[3] + f[4], f[4], ge7, f[6], s910, f[8], f[10]]
    return torch.stack(tot, -1), torch.stack(ones, -1)


def token_stats_rows_plain(luma_mode, y2_levels, y_levels, uv_levels, skipped, mbw: int,
                           mbh: int, seg: int = SEG_MBS, chunk_rows: int = CHUNK_ROWS,
                           order=None):
    """Twin of the K6 kernel's schedule (CPU).  CTAs (image, MB row, run of
    <= seg MBs) in `order` (indices into their list in (image, row, run)
    order; all in order by default).  A CTA finds each column's nearest MB
    with a Y2 block above it by scanning `chunk_rows` rows of modes at a
    time bottom up, the nearest left of its run by a scan of the row, takes
    the flags of the row above's bottom blocks and of the MB left of the
    run, makes each MB's 25-bit flag mask and skip flag (`skipped` None:
    derived), the Y2 context from the left by a max-scan of (column * 2 +
    flag) in chunks of 32 with a carry, then one event code a (block,
    position) of the blocks that code tokens (which the kernel lists by
    the lanes their events need, in any order) into a [type, position,
    context, code] histogram, folded into bands and nodes; per image the
    counters and a ticket, the last CTA writing them out and zeroing them."""
    B, nmb = luma_mode.shape
    lm_all = luma_mode.cpu().to(torch.int64)
    y2l, yl, uvl = (t.cpu() for t in (y2_levels, y_levels, uv_levels))
    nseg = -(-mbw // seg)
    ctas = [(b, my, s) for b in range(B) for my in range(mbh) for s in range(nseg)]
    if order is not None:
        ctas = [ctas[i] for i in order]
    out = torch.full((2, B, 4, 8, 3, 11), -1, dtype=torch.int32)
    acc = torch.zeros((B, 2, 4, 8, 3, 11), dtype=torch.int32)
    tickets = [0] * B
    bands = torch.from_numpy(BANDS)
    for b, my, s in ctas:
        x0 = s * seg
        n_mb = min(seg, mbw - x0)
        lm = lm_all[b].reshape(mbh, mbw)
        run_ms = torch.arange(n_mb) + my * mbw + x0
        lev = _mb_blocks(y2l, yl, uvl, b, run_ms)
        has = lm[my, x0:x0 + n_mb] != 4
        # The Y2 context from above: chunks of rows, bottom up.
        found = [-1] * n_mb
        hi = my - 1
        while hi >= 0:
            lo = max(hi - chunk_rows + 1, 0)
            for i in range(n_mb):
                if found[i] < 0:
                    rows = [r for r in range(hi, lo - 1, -1) if lm[r, x0 + i] != 4]
                    found[i] = rows[0] if rows else -1
            if all(f >= 0 for f in found) or lo == 0:
                break
            hi = lo - 1
        top = [int(y2l[b, r * mbw + x0 + i].ne(0).any()) if r >= 0 else 0
               for i, r in enumerate(found)]
        left_cols = [c for c in range(x0 - 1, -1, -1) if lm[my, c] != 4]
        left_in = int(y2l[b, my * mbw + left_cols[0]].ne(0).any()) if left_cols else 0
        mask = [0] * (n_mb + 1)
        if x0 > 0:
            m = my * mbw + x0 - 1
            mask[0] = _bits(_ctx_flags(_mb_blocks(y2l, yl, uvl, b, [m]), lm[my, x0 - 1:x0] != 4)[0])
        above = [0] * n_mb
        if my > 0:
            up = _ctx_flags(_mb_blocks(y2l, yl, uvl, b, run_ms - mbw),
                            lm[my - 1, x0:x0 + n_mb] != 4)
            above = [_bits(f[BELOW]) for f in up]
        flags = _ctx_flags(lev, has)
        for i in range(n_mb):
            mask[i + 1] = _bits(flags[i])
        skip = (~_nz_bits(lev)[0].any(-1) if skipped is None
                else skipped[b, run_ms].cpu().bool())
        # The Y2 context from the left: an inclusive max-scan per chunk of 32.
        y2ctx = [0] * n_mb
        carry = left_in
        for base in range(0, n_mb, 32):
            keys, best = [], -1
            for i in range(base, min(base + 32, n_mb)):
                best = max(best, i * 2 + (mask[i + 1] & 1) if has[i] else -1)
                keys.append(best)
            for k, i in enumerate(range(base, min(base + 32, n_mb))):
                prev = keys[k - 1] if k else -1
                y2ctx[i] = (prev & 1 if prev >= 0 else carry) + top[i]
            carry = keys[-1] & 1 if keys[-1] >= 0 else carry
        # Events: one code a (block, position).
        slot = torch.arange(25)[None, :].expand(n_mb, 25)
        act = ~skip[:, None] & ((slot != 0) | has[:, None])
        ctype = torch.where(slot == 0, 1, torch.where(slot <= 16,
                                                      torch.where(has[:, None], 0, 3), 2))
        first = (ctype == 0).to(torch.int64)[..., None]
        pos = torch.arange(16)
        v = torch.where(act[..., None], lev.abs(), 0).to(torch.int64)
        in_run = (v != 0) & (pos >= first)
        last = torch.where(in_run, pos, -1).amax(-1, keepdim=True)
        end = last + 1
        vprev = torch.cat([v[..., :1], v[..., :-1]], dim=-1)
        ctx0 = torch.tensor([[_first_ctx(sl, i, mask, above[i], y2ctx) for sl in range(25)]
                             for i in range(n_mb)], dtype=torch.int64)
        code = torch.full_like(v, -1)
        cls = _token_class(v)
        at_first = pos == first
        code = torch.where(at_first, torch.where(end > 0, cls, EOB), code)
        code = torch.where((pos > first) & (pos < end), cls, code)
        code = torch.where((pos == end) & (pos > first), EOB, code)
        ctx = torch.where(at_first, ctx0[..., None], vprev.clamp_max(2))
        live = act[..., None] & (code >= 0)
        hist = torch.zeros((4, 16, 3, 12), dtype=torch.int32)
        idx = (ctype[..., None].expand_as(v)[live], pos.expand_as(v)[live], ctx[live], code[live])
        hist.index_put_(idx, torch.ones(len(idx[0]), dtype=torch.int32), accumulate=True)
        fold = torch.zeros((4, 8, 3, 12), dtype=torch.int32)
        fold.index_add_(1, bands, hist)
        tot, ones = _nodes(fold)
        acc[b, 0] += tot
        acc[b, 1] += ones
        tickets[b] += 1
        if tickets[b] == mbh * nseg:
            out[:, b] = acc[b]
            acc[b] = 0
            tickets[b] = 0
    return out[0], out[1]

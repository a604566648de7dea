"""Kernel K3: the VP8 loop filter over whole planes, in place.

Replaces `webp_tpu/ops/loopfilter2.py:192` `filter_step` (driven by
`loop_filter_frames_v2` :280 and `wavefront2.decode_frames_fused_v2`).
Filtering MB (x, y) reads pixels that (x-1, y), (x, y-1) and (x+1, y-1)
have filtered, so MBs run in anti-diagonal order t = x + 2y; the MBs of a
diagonal touch disjoint pixels.

The CUDA kernel is `csrc/wavefront_rows.cu` (the `<no recon, filter>`
instance of the row-CTA kernel that `ops/recon_filter.py` fuses with the
recon); `loop_filter_plain_` is its torch twin, vectorised over the MBs of a diagonal and the batch, with the filter
math of `webp_tpu/ops/loopfilter2.py` (RFC 6386 15.2-15.3).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from .wavefront import diagonal, row_scratch


def _c(v):
    return v.clamp(-128, 127)


def _u(v):
    return _c(v) + 128


def _simple_threshold(c, limit):
    return ((c[3] - c[4]).abs() * 2 + (c[2] - c[5]).abs() // 2) <= limit


def _should_filter(c, interior, limit):
    ok = _simple_threshold(c, limit)
    for a, b in ((0, 1), (1, 2), (2, 3), (7, 6), (6, 5), (5, 4)):
        ok = ok & ((c[a] - c[b]).abs() <= interior)
    return ok


def _hev(c, threshold):
    return ((c[2] - c[3]).abs() > threshold) | ((c[5] - c[4]).abs() > threshold)


def _common_adjust(c, use_outer, mask):
    p1, p0, q0, q1 = c[2] - 128, c[3] - 128, c[4] - 128, c[5] - 128
    outer = _c(p1 - q1)
    if use_outer is not True:
        outer = torch.where(use_outer, outer, 0)
    a = _c(outer + 3 * (q0 - p0))
    b = _c(a + 3) >> 3
    a4 = _c(a + 4) >> 3
    c[4] = torch.where(mask, _u(q0 - a4), c[4])
    c[3] = torch.where(mask, _u(p0 + b), c[3])
    return a4


def _filter_window(c, kind, hev_t, interior, limit, enabled, simple):
    """c: 8 tensors p3 p2 p1 p0 q0 q1 q2 q3 [B, n, L]; params [B, n, 1]."""
    c = list(c)
    if simple:
        _common_adjust(c, True, _simple_threshold(c, limit) & enabled)
        return c
    mask = _should_filter(c, interior, limit) & enabled
    hv = _hev(c, hev_t)
    if kind == "mb":
        wide = mask & ~hv
        p2, p1, p0 = c[1] - 128, c[2] - 128, c[3] - 128
        q0, q1, q2 = c[4] - 128, c[5] - 128, c[6] - 128
        wv = _c(_c(p1 - q1) + 3 * (q0 - p0))
        a0 = _c((27 * wv + 63) >> 7)
        a1 = _c((18 * wv + 63) >> 7)
        a2 = _c((9 * wv + 63) >> 7)
        c[4] = torch.where(wide, _u(q0 - a0), c[4])
        c[3] = torch.where(wide, _u(p0 + a0), c[3])
        c[5] = torch.where(wide, _u(q1 - a1), c[5])
        c[2] = torch.where(wide, _u(p1 + a1), c[2])
        c[6] = torch.where(wide, _u(q2 - a2), c[6])
        c[1] = torch.where(wide, _u(p2 + a2), c[1])
        _common_adjust(c, True, mask & hv)
    else:
        q1, p1 = c[5] - 128, c[2] - 128
        a = _common_adjust(c, hv, mask)
        a1 = (a + 1) >> 1
        outer = mask & ~hv
        c[5] = torch.where(outer, _u(q1 - a1), c[5])
        c[2] = torch.where(outer, _u(p1 + a1), c[2])
    return c


def _filter_patch(patch, n: int, has_left, has_top, level, interior, hev_t, do_sub, simple):
    """Filter patches [B, k, n+4, n+4] in place: MB pixels at [4:, 4:] with 4
    margin rows above and columns left.  has_left/has_top [k] bool, the
    parameters [B, k]."""
    on = level > 0
    mb_lim = ((level + 2) * 2 + interior)[..., None]
    sub_lim = (level * 2 + interior)[..., None]
    hv_t = hev_t[..., None]
    intr = interior[..., None]
    en_left = (has_left & on)[..., None]
    en_top = (has_top & on)[..., None]
    en_sub = (on & do_sub)[..., None]

    def v_edge(col, kind, lim, en):
        c = [patch[:, :, 4:, col - 4 + k].clone() for k in range(8)]
        c = _filter_window(c, kind, hv_t, intr, lim, en, simple)
        for k in range(1, 7):
            patch[:, :, 4:, col - 4 + k] = c[k]

    def h_edge(row, kind, lim, en):
        c = [patch[:, :, row - 4 + k, 4:].clone() for k in range(8)]
        c = _filter_window(c, kind, hv_t, intr, lim, en, simple)
        for k in range(1, 7):
            patch[:, :, row - 4 + k, 4:] = c[k]

    v_edge(4, "mb", mb_lim, en_left)
    for col in range(8, n + 3, 4):
        v_edge(col, "sub", sub_lim, en_sub)
    h_edge(4, "mb", mb_lim, en_top)
    for row in range(8, n + 3, 4):
        h_edge(row, "sub", sub_lim, en_sub)


def filter_mbs_(work, R, X, has_top, params, simple: bool) -> None:
    """Filter MBs of one diagonal in int32 workspaces with 4 margin rows
    above and columns left: work [(plane [B, 4 + rows, 4 + cols], n)], R [n]
    the MBs' rows in the workspaces, X [n] their columns, has_top [n] whether
    the frame has a row above them, params (level, interior, hev, do_sub)
    [B, n]."""
    for pw, n in work:
        k = torch.arange(n + 4, device=pw.device)
        ri = ((R * n)[:, None] + k)[:, :, None]  # padded rows of the patches
        ci = ((X * n)[:, None] + k)[:, None, :]
        patch = pw[:, ri, ci]
        _filter_patch(patch, n, X > 0, has_top, *params, simple)
        pw[:, ri, ci] = patch


def filter_params(level, interior, hev, do_sub):
    """The per-MB filter parameters as the workspaces' step functions take
    them: level, interior, hev int32 and do_sub bool [B, nmb]."""
    return (*(t.to(torch.int32) for t in (level, interior, hev)), do_sub.bool())


def loop_filter_plain_(y, u, v, level, interior, hev, do_sub, simple: bool) -> None:
    """Torch twin of the loop-filter kernel; filters y/u/v in place."""
    B, H, W = y.shape
    mbh, mbw = H // 16, W // 16
    dev = y.device
    planes = [(y, 16)] if simple else [(y, 16), (u, 8), (v, 8)]
    work = [(F.pad(p.to(torch.int32), (4, 0, 4, 0)), n) for p, n in planes]
    params = filter_params(level, interior, hev, do_sub)
    for t in range(mbw + 2 * (mbh - 1)):
        rows = diagonal(t, range(mbh), mbw)
        if rows is None:  # one MB column: odd diagonals are empty
            continue
        R, X = (a.to(dev) for a in rows)
        M = R * mbw + X
        filter_mbs_(work, R, X, R > 0, [p[:, M] for p in params], simple)
    for (p, _), (pw, _) in zip(planes, work):
        p.copy_(pw[:, 4:, 4:].to(torch.uint8))


def loop_filter_(y, u, v, level, interior, hev, do_sub, simple: bool) -> None:
    """Filter the planes y [B, mbh*16, mbw*16], u/v [B, mbh*8, mbw*8] uint8
    in place with the per-MB level/interior/hev (uint8) and do_sub (bool)
    [B, nmb].  The simple filter leaves chroma untouched."""
    dev = _build.same_device(y, u, v, level, interior, hev, do_sub)
    if dev.type == "cpu":
        return loop_filter_plain_(y, u, v, level, interior, hev, do_sub, simple)
    B, H, W = y.shape
    mbh, mbw = H // 16, W // 16
    nmb = mbw * mbh
    args = [*_build.plane(y, B, H, W), *_build.plane(u, B, mbh * 8, mbw * 8),
            *_build.plane(v, B, mbh * 8, mbw * 8)]
    for f in (level, interior, hev, do_sub):
        args += _build.mb_field(f, B, nmb)
    _, prog = row_scratch(B, mbh, mbw, dev, edge=False)
    _build.launch("loopfilter", "webp_loopfilter", dev, *args, mbw, mbh, B, int(simple),
                  prog.data_ptr())

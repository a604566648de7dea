"""Kernel K2: intra prediction + residue over the MB grid, in wavefront order.

Replaces `webp_tpu/ops/wavefront2.py:152` `recon_step` (driven by
`decode_frames_fused_v2` :274 and `reconstruct_frames_v2` :337).  The
output planes hold the UNFILTERED reconstruction: prediction reads
unfiltered neighbours, and the loop filter (`ops/loopfilter.py`) runs over
the finished planes afterwards.

The CUDA kernel is `csrc/wavefront_rows.cu` (the `<recon, no filter>`
instance of the row-CTA kernel that `ops/recon_filter.py` fuses with the
filter); `recon_plain_` is its torch twin.  It walks the anti-diagonals
t = x + 2y in Python, vectorised over the MBs of a diagonal and the batch,
and builds each MB's bordered workspace the way `webp_tpu/ops/predict.py`
`create_border_luma` does.
"""

from __future__ import annotations

import torch

from .. import _build


def _avg2(a, b):
    return (a + b + 1) >> 1


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def predict_b_all(e: torch.Tensor) -> torch.Tensor:
    """All ten 4x4 B-mode predictions (RFC 6386 12.3, ops/predict.py).

    e [..., 13] int32 = (L3, L2, L1, L0, top-left, A0..A7) -> [..., 10, 16]
    in mode order B_DC, B_TM, B_VE, B_HE, B_LD, B_RD, B_VR, B_VL, B_HD, B_HU.
    """
    E = [e[..., i] for i in range(13)]
    L = [E[3], E[2], E[1], E[0]]
    P = E[4]
    A = E[5:13]
    dc = (4 + A[0] + A[1] + A[2] + A[3] + L[0] + L[1] + L[2] + L[3]) >> 3
    tm = [(L[r] + A[c] - P).clamp(0, 255) for r in range(4) for c in range(4)]
    ve = [_avg3(P, A[0], A[1]), _avg3(A[0], A[1], A[2]),
          _avg3(A[1], A[2], A[3]), _avg3(A[2], A[3], A[4])]
    he = [_avg3(P, L[0], L[1]), _avg3(L[0], L[1], L[2]),
          _avg3(L[1], L[2], L[3]), _avg3(L[2], L[3], L[3])]
    ld = [_avg3(A[i], A[i + 1], A[min(i + 2, 7)]) for i in range(7)]
    rd = [_avg3(E[i], E[i + 1], E[i + 2]) for i in range(7)]

    vr = [None] * 16
    vr[12] = _avg3(E[1], E[2], E[3])
    vr[8] = _avg3(E[2], E[3], E[4])
    vr[13] = vr[4] = _avg3(E[3], E[4], E[5])
    vr[9] = vr[0] = _avg2(E[4], E[5])
    vr[14] = vr[5] = _avg3(E[4], E[5], E[6])
    vr[10] = vr[1] = _avg2(E[5], E[6])
    vr[15] = vr[6] = _avg3(E[5], E[6], E[7])
    vr[11] = vr[2] = _avg2(E[6], E[7])
    vr[7] = _avg3(E[6], E[7], E[8])
    vr[3] = _avg2(E[7], E[8])

    vl = [None] * 16
    vl[0] = _avg2(A[0], A[1])
    vl[4] = _avg3(A[0], A[1], A[2])
    vl[8] = vl[1] = _avg2(A[1], A[2])
    vl[5] = vl[12] = _avg3(A[1], A[2], A[3])
    vl[9] = vl[2] = _avg2(A[2], A[3])
    vl[13] = vl[6] = _avg3(A[2], A[3], A[4])
    vl[10] = vl[3] = _avg2(A[3], A[4])
    vl[14] = vl[7] = _avg3(A[3], A[4], A[5])
    vl[11] = _avg3(A[4], A[5], A[6])
    vl[15] = _avg3(A[5], A[6], A[7])

    hd = [None] * 16
    hd[12] = _avg2(E[0], E[1])
    hd[13] = _avg3(E[0], E[1], E[2])
    hd[8] = hd[14] = _avg2(E[1], E[2])
    hd[9] = hd[15] = _avg3(E[1], E[2], E[3])
    hd[10] = hd[4] = _avg2(E[2], E[3])
    hd[11] = hd[5] = _avg3(E[2], E[3], E[4])
    hd[6] = hd[0] = _avg2(E[3], E[4])
    hd[7] = hd[1] = _avg3(E[3], E[4], E[5])
    hd[2] = _avg3(E[4], E[5], E[6])
    hd[3] = _avg3(E[5], E[6], E[7])

    hu = [None] * 16
    hu[0] = _avg2(L[0], L[1])
    hu[1] = _avg3(L[0], L[1], L[2])
    hu[2] = hu[4] = _avg2(L[1], L[2])
    hu[3] = hu[5] = _avg3(L[1], L[2], L[3])
    hu[6] = hu[8] = _avg2(L[2], L[3])
    hu[7] = hu[9] = _avg3(L[2], L[3], L[3])
    hu[10] = hu[11] = hu[12] = hu[13] = hu[14] = hu[15] = L[3]

    modes = [
        [dc] * 16, tm,
        [ve[c] for r in range(4) for c in range(4)],
        [he[r] for r in range(4) for c in range(4)],
        [ld[r + c] for r in range(4) for c in range(4)],
        [rd[3 - r + c] for r in range(4) for c in range(4)],
        vr, vl, hd, hu,
    ]
    return torch.stack([torch.stack(m, dim=-1) for m in modes], dim=-2)


def predict_whole(a, left, tl, mode, has_above, has_left, size: int):
    """DC/V/H/TM prediction: a/left [B, n, size], tl [B, n], mode [B, n],
    has_above/has_left [n] bool -> [B, n, size, size]."""
    ha = has_above.to(torch.int32)
    hl = has_left.to(torch.int32)
    shf = (2 if size == 8 else 3) + ha + hl
    total = left.sum(-1, dtype=torch.int32) * hl + a.sum(-1, dtype=torch.int32) * ha
    dc = torch.where((ha + hl) > 0, (total + (torch.ones_like(shf) << (shf - 1))) >> shf, 128)
    shape = a.shape[:-1] + (size, size)
    dc_blk = dc[..., None, None].expand(shape)
    v_blk = a[..., None, :].expand(shape)
    h_blk = left[..., :, None].expand(shape)
    tm_blk = (left[..., :, None] + a[..., None, :] - tl[..., None, None]).clamp(0, 255)
    m = mode[..., None, None]
    return torch.where(m == 0, dc_blk, torch.where(m == 1, v_blk, torch.where(m == 2, h_blk, tm_blk)))


def _blocks_to_spatial(blk: torch.Tensor, n: int) -> torch.Tensor:
    """[B, k, n*n, 16] raster 4x4 blocks -> [B, k, 4n, 4n]."""
    B, k = blk.shape[:2]
    return blk.reshape(B, k, n, n, 4, 4).permute(0, 1, 2, 4, 3, 5).reshape(B, k, 4 * n, 4 * n)


def _bordered(p: torch.Tensor) -> torch.Tensor:
    """int32 copy of planes [B, H, W] with the frame border: row 0 is the row
    above the frame (127, its corner included), column 0 the column left of
    it (129)."""
    B, H, W = p.shape
    w = torch.full((B, H + 1, W + 1), 129, dtype=torch.int32, device=p.device)
    w[:, 0, :] = 127
    return w


def recon_mbs_(Yw, Uw, Vw, R, X, M, has_above, res, lm_all, bp_all, cm_all,
               has_left=None) -> None:
    """Reconstruct MBs of one diagonal into int32 workspaces with a border
    row above and column left (`_bordered`): R [n] their rows in the
    workspaces, X [n] their columns, M [n] their MB indices in the per-MB
    arrays, has_above [n] whether the frame has a row above them and
    has_left [n] one left of them (default X > 0)."""
    B, W = Yw.shape[0], Yw.shape[2] - 1
    dev = Yw.device
    k16 = torch.arange(16, device=dev)
    k8 = torch.arange(8, device=dev)
    k4 = torch.arange(4, device=dev)
    n = len(R)
    lm, cm = lm_all[:, M], cm_all[:, M]
    rs = res[:, M]  # [B, n, 24, 16]
    if has_left is None:
        has_left = X > 0

    # Luma workspace [B, n, 17, 21] as in create_border_luma.
    top = (R * 16)[:, None]
    ws = torch.zeros((B, n, 17, 21), dtype=torch.int32, device=dev)
    ws[:, :, 0, 1:17] = Yw[:, top, 1 + (X * 16)[:, None] + k16]
    tr_cols = (X * 16 + 16)[:, None] + k4
    ws[:, :, 0, 17:21] = Yw[:, top, 1 + tr_cols.clamp(max=W - 1)]  # rightmost MB repeats a[15]
    for r in (4, 8, 12):
        ws[:, :, r, 17:21] = ws[:, :, 0, 17:21]
    ws[:, :, 1:17, 0] = Yw[:, 1 + top + k16, (X * 16)[:, None]]
    ws[:, :, 0, 0] = Yw[:, R * 16, X * 16]

    pred16 = predict_whole(ws[:, :, 0, 1:17], ws[:, :, 1:17, 0], ws[:, :, 0, 0],
                           lm.clamp(max=3), has_above, has_left, 16)
    recon16 = (pred16 + _blocks_to_spatial(rs[:, :, :16], 4)).clamp(0, 255)

    for i in range(16):
        y0, x0 = 1 + (i // 4) * 4, 1 + (i % 4) * 4
        e = torch.cat([
            ws[:, :, y0 + 3, x0 - 1 : x0], ws[:, :, y0 + 2, x0 - 1 : x0],
            ws[:, :, y0 + 1, x0 - 1 : x0], ws[:, :, y0, x0 - 1 : x0],
            ws[:, :, y0 - 1, x0 - 1 : x0 + 8],
        ], dim=-1)
        preds = predict_b_all(e)  # [B, n, 10, 16]
        mode = bp_all[:, M, i][..., None, None].expand(B, n, 1, 16)
        pred = torch.gather(preds, 2, mode)[:, :, 0]
        blk = (pred + rs[:, :, i]).clamp(0, 255).reshape(B, n, 4, 4)
        ws[:, :, y0 : y0 + 4, x0 : x0 + 4] = blk
    luma = torch.where((lm == 4)[..., None, None], ws[:, :, 1:17, 1:17], recon16)
    Yw[:, 1 + top[:, :, None] + k16[:, None], 1 + (X * 16)[:, None, None] + k16] = luma

    ctop = (R * 8)[:, None]
    for j, Cw in enumerate((Uw, Vw)):
        a8 = Cw[:, ctop, 1 + (X * 8)[:, None] + k8]
        left8 = Cw[:, 1 + ctop + k8, (X * 8)[:, None]]
        tl = Cw[:, R * 8, X * 8]
        pred = predict_whole(a8, left8, tl, cm, has_above, has_left, 8)
        blk = _blocks_to_spatial(rs[:, :, 16 + 4 * j : 20 + 4 * j], 2)
        Cw[:, 1 + ctop[:, :, None] + k8[:, None], 1 + (X * 8)[:, None, None] + k8] = (
            (pred + blk).clamp(0, 255)
        )


def diagonal(t: int, rows, mbw: int):
    """(rows, columns) tensors of the MBs of diagonal t among MB rows `rows`
    (a range), or None when it has none."""
    active = [r for r in rows if 0 <= t - 2 * r < mbw]
    if not active:
        return None
    R = torch.tensor(active)
    return R, t - 2 * R


def recon_plain_(y, u, v, residuals, luma_mode, bpred, chroma_mode) -> None:
    """Torch twin of the recon kernel; writes the planes y/u/v in place."""
    B, H, W = y.shape
    mbh, mbw = H // 16, W // 16
    dev = y.device
    Yw, Uw, Vw = _bordered(y), _bordered(u), _bordered(v)
    args = (residuals.to(torch.int32), luma_mode.long(), bpred.long(), chroma_mode.long())
    for t in range(mbw + 2 * (mbh - 1)):
        rows = diagonal(t, range(mbh), mbw)
        if rows is None:  # one MB column: odd diagonals are empty
            continue
        R, X = (a.to(dev) for a in rows)
        recon_mbs_(Yw, Uw, Vw, R, X, R * mbw + X, R > 0, *args)
    for p, w in ((y, Yw), (u, Uw), (v, Vw)):
        p.copy_(w[:, 1:, 1:].to(torch.uint8))


def row_scratch(batch: int, mbh: int, mbw: int, device, edge: bool = True):
    """The row-CTA kernels' scratch, zeroed: the rows' unfiltered bottom
    pixels [B, mbh, 2 * 16 mbw] uint8 (luma, then U and V; None without
    `edge`) and the rows' progress counters [B * mbh] then the row ticket,
    int32."""
    rows = torch.zeros((batch, mbh, 32 * mbw), dtype=torch.uint8, device=device) if edge else None
    return rows, torch.zeros(batch * mbh + 1, dtype=torch.int32, device=device)


def recon_(y, u, v, residuals, luma_mode, bpred, chroma_mode) -> None:
    """Reconstruct into the planes y [B, mbh*16, mbw*16], u/v [B, mbh*8,
    mbw*8] uint8 (rows packed, any batch stride) from residuals int32
    [B, nmb, 24, 16] and the per-MB modes luma_mode [B, nmb], bpred
    [B, nmb, 16], chroma_mode [B, nmb] uint8."""
    dev = _build.same_device(y, u, v, residuals, luma_mode, bpred, chroma_mode)
    if dev.type == "cpu":
        return recon_plain_(y, u, v, residuals, luma_mode, bpred, chroma_mode)
    B, H, W = y.shape
    mbh, mbw = H // 16, W // 16
    nmb = mbw * mbh
    edge, prog = row_scratch(B, mbh, mbw, dev)
    _build.launch(
        "recon", "webp_recon", dev,
        _build.dense(residuals, torch.int32, (B, nmb, 24, 16)),
        *_build.mb_field(luma_mode, B, nmb), *_build.mb_field(bpred, B, nmb, 16),
        *_build.mb_field(chroma_mode, B, nmb),
        mbw, mbh, B,
        *_build.plane(y, B, mbh * 16, mbw * 16), *_build.plane(u, B, mbh * 8, mbw * 8),
        *_build.plane(v, B, mbh * 8, mbw * 8),
        edge.data_ptr(), prog.data_ptr(),
    )

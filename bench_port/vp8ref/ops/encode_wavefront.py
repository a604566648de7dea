"""Frozen copy of the plain code of `webp_tpu_torch/ops/encode_wavefront.py`, the
benchmark's reference; it imports nothing of the port.

Kernel K5: the encoder's full-RD mode decision with reconstruction in the
loop, over the MB grid in wavefront order.

Replaces `webp_tpu/ops/encode_wavefront2.py:803` `enc_step` (with
`_i16_search_v2` :362, `_i4_search_v2` :585, `_uv_search_v2` :696,
`_chroma_diffusion_v2` :735, `_i16_trellis_v2` :418 and `_i4_trellis_v2`
:467), driven by `encode_analysis_batch_v2` (:955).  Each MB takes the
quantizers and lambdas of its segment (`sid`; all 0 with segments off).
Per MB:
  - I16: the four whole-block modes, DCT + Y2 WHT, quantization, rate
    (`ops/enc_costs.py`), spectral and pixel distortion, flat-source
    penalty; the best by RD score at lambda_i16, rescored at lambda_mode;
  - I4 (n_try > 0): the 16 subblocks in order, each trying DC and the
    n_try - 1 B modes of least prediction SSE, with the running-score early
    exit against the I16 score and the 64-bit/MB header budget;
  - with `do_trellis` (methods 4-6, pass 2), the chosen luma path is
    quantized again by the trellis (`ops/trellis.py`): I16's 16 blocks under
    all three entry contexts, then resolved in raster order; I4's 16
    subblocks in order with their modes fixed, each predicted from the
    trellis reconstruction.  Entry contexts cross MBs through the nnz of
    the neighbours' final levels; the reconstruction follows the trellis;
  - UV: the four modes with the flatness penalty, then chroma DC error
    diffusion and the final quantization.
Outputs per MB: luma_mode (4 = B-predicted), chroma_mode, bpred [16],
y_levels [16, 16], y2_levels [16], uv_levels [8, 16] (zigzag levels).

`encode_analysis_batch_plain` is the plain torch form (any device).  The twin walks the anti-diagonals t = x + 2y in Python, vectorised
over the diagonal's MBs and the batch ([n, B] lanes), and reads neighbours
back from the reconstruction it writes, as the kernel does.
"""

from __future__ import annotations

import torch

from .. import _consts
from .enc_costs import residual_costs
from .enc_params import BIG, CONSTS_NP, IZZ, ZZ, EncParams, EncTables, rd_score32
from .transform import dct4x4, idct4x4, iwht4x4, quantize_zz, wht4x4
from .trellis import trellis_par, trellis_spec3
from .wavefront import predict_b_all

_ZZ = torch.from_numpy(ZZ)
_IZZ = torch.from_numpy(IZZ)


def _const(name: str, dev) -> torch.Tensor:
    c = _consts.device_constant("enc_consts", CONSTS_NP, dev)
    lo, hi = {"fixed_i4": (2048, 3048), "fixed_i16": (3048, 3052), "fixed_uv": (3052, 3056),
              "weight_y": (3056, 3072)}[name]
    return c[lo:hi]


OUT_FIELDS = ("luma_mode", "chroma_mode", "bpred", "y_levels", "y2_levels", "uv_levels")


def _quant(blocks_raster, iq, bias):
    return quantize_zz(blocks_raster[..., _ZZ.to(blocks_raster.device)], iq, bias)


def _dequant(levels, q):
    return (levels * q)[..., _IZZ.to(levels.device)]


def _blocks(mb, n: int):
    """[..., 4n, 4n] spatial <-> [..., n*n, 16] raster 4x4 blocks."""
    s = mb.shape[:-2]
    return mb.reshape(*s, n, 4, n, 4).transpose(-3, -2).reshape(*s, n * n, 16)


def _spatial(blk, n: int):
    s = blk.shape[:-2]
    return blk.reshape(*s, n, n, 4, 4).transpose(-3, -2).reshape(*s, 4 * n, 4 * n)


def _t_transform(blocks4, w):
    """Weighted Hadamard energy of [..., 4, 4] blocks -> [...]."""
    b = blocks4.to(torch.int32)
    e0, e1, e2, e3 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    a0, a1, a2, a3 = e0 + e2, e1 + e3, e1 - e3, e0 - e2
    t = torch.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], dim=-1)
    c0, c1, c2, c3 = t[..., 0, :], t[..., 1, :], t[..., 2, :], t[..., 3, :]
    a0, a1, a2, a3 = c0 + c2, c1 + c3, c1 - c3, c0 - c2
    out = torch.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], dim=-2)
    return (out.abs() * w.reshape(4, 4)).sum((-1, -2), dtype=torch.int32)


def _ex(v, k: int):
    """Per-lane [n, B, ...] parameters with k broadcast axes after [n, B]."""
    return v.reshape(*v.shape[:2], *([1] * k), *v.shape[2:])


def _spectral(tlambda, td):
    return torch.where(tlambda > 0, (tlambda * td + 128) >> 8, 0)


def _tables(tbl: EncTables, ctype: int, k: int):
    """The (cls, eob, init) costs of token type `ctype` for [n, B] lanes with
    k more block axes: [1, B, 1 x k, 16, ...]."""
    return tuple(_ex(getattr(tbl, f)[None, :, ctype], k)
                 for f in ("cls_cost", "eob_cost", "init_cost"))


def _whole_pred_all4(a, left, tl, has_above, has_left, size: int):
    """DC/V/H/TM predictions, a/left [n, B, (2,) size], tl [n, B(, 2)],
    has_* [n, 1(, 1)] -> [n, B, (2,) 4, size, size]."""
    ha, hl = has_above.to(torch.int32), has_left.to(torch.int32)
    shf = (2 if size == 8 else 3) + ha + hl
    total = left.sum(-1, dtype=torch.int32) * hl + a.sum(-1, dtype=torch.int32) * ha
    dc = torch.where((ha + hl) > 0, (total + (1 << (shf - 1))) >> shf, 128)
    shape = a.shape[:-1] + (size, size)
    dc_blk = dc[..., None, None].expand(shape)
    v_blk = a[..., None, :].expand(shape)
    h_blk = left[..., :, None].expand(shape)
    tm_blk = (left[..., :, None] + a[..., None, :] - tl[..., None, None]).clamp(0, 255)
    return torch.stack([dc_blk, v_blk, h_blk, tm_blk], dim=-3)


def _allowed(has_above, has_left, shape):
    ha, hl = has_above.expand(shape), has_left.expand(shape)
    return torch.stack([torch.ones_like(ha), ha, hl, ha & hl], dim=-1)


def _pick(x, k):
    """x [n, B, M, ...], k [n, B] -> x[:, :, k]."""
    idx = k.long().reshape(*k.shape, 1, *([1] * (x.ndim - 3)))
    idx = idx.expand(*k.shape, 1, *x.shape[3:])
    return torch.gather(x, 2, idx)[:, :, 0]


def _i16_search(a16, left16, tl, src, has_above, has_left, P, tbl):
    """src [n, B, 16, 16], per-lane P -> (mode [n, B], score at lambda_mode,
    y2 levels [n, B, 16], y levels [n, B, 16, 16], rec [n, B, 16, 16], and
    the chosen mode's raster DCT blocks and spatial prediction)."""
    n, B = src.shape[:2]
    pred4 = _whole_pred_all4(a16, left16, tl, has_above, has_left, 16)
    dct = dct4x4(_blocks(src[:, :, None] - pred4, 4))          # [n, B, 4, 16, 16]
    y2_lv = _quant(wht4x4(dct[..., 0]), _ex(P.y2_iq, 1), _ex(P.y2_bias, 1))  # [n, B, 4, 16]
    y_lv = _quant(dct, _ex(P.y1_iq, 2), _ex(P.y1_bias, 2))
    y_lv[..., 0] = 0
    cost = (residual_costs(y2_lv, 1, 0, 0, tbl)
            + residual_costs(y_lv, 0, 1, 0, tbl).sum(-1, dtype=torch.int32))

    blk = _dequant(y_lv, _ex(P.y1_q, 2))
    blk[..., 0] = iwht4x4(_dequant(y2_lv, _ex(P.y2_q, 1)))
    rec = (pred4 + _spatial(idct4x4(blk), 4)).clamp(0, 255)
    d = ((rec - src[:, :, None]) ** 2).sum((-1, -2), dtype=torch.int32)
    w = _const("weight_y", src.device)
    tsrc = _t_transform(_blocks(src, 4).reshape(n, B, 16, 4, 4), w)
    trec = _t_transform(_blocks(rec, 4).reshape(n, B, 4, 16, 4, 4), w)
    sd = _spectral(_ex(P.tlambda, 1),
                   ((trec - tsrc[:, :, None]).abs() >> 5).sum(-1, dtype=torch.int32))

    is_flat = (src == src[..., 0:1, 0:1]).all(-1).all(-1)
    flat_pen = is_flat[..., None] & ((y_lv[..., 1:] != 0).sum((-1, -2)) <= 0)
    d = torch.where(flat_pen, d * 2, d)
    sd = torch.where(flat_pen, sd * 2, sd)

    rate = _const("fixed_i16", src.device) + cost
    scores = torch.where(_allowed(has_above, has_left, (n, B)),
                         rd_score32(rate, d + sd, _ex(P.lambda_i16, 1)), BIG)
    best = scores.argmin(-1)
    final = rd_score32(_pick(rate, best), _pick(d + sd, best), P.lambda_mode)
    return (best, final, _pick(y2_lv, best), _pick(y_lv, best), _pick(rec, best),
            _pick(dct, best), _pick(pred4, best))


def _i4_workspace(a16, tr4, tl, left16):
    """Bordered I4 workspace [n, B, 17, 21]: row 0 = [tl | above |
    above-right], column 0 = left; column-3 subblocks of rows 4/8/12 reuse
    the MB's above-right pixels; the reconstruction fills the rest."""
    n, B = tl.shape
    ws = torch.zeros((n, B, 17, 21), dtype=torch.int32, device=tl.device)
    ws[..., 0, :] = torch.cat([tl[..., None], a16, tr4], dim=-1)
    ws[..., 1:, 0] = left16
    for rr in (4, 8, 12):
        ws[..., rr, 17:21] = tr4
    return ws


def _i4_preds(ws, sby: int, sbx: int):
    """The ten B-mode predictions [n, B, 10, 16] of subblock (sby, sbx)."""
    p = ws[..., sby * 4 : sby * 4 + 5, sbx * 4 : sbx * 4 + 9]
    return predict_b_all(torch.cat([p[..., [4, 3, 2, 1], 0], p[..., 0, 0:9]], dim=-1))


def _i16_trellis(dct, y2_lv, pred, top_nz, left_nz, P, tbl):
    """The 16 Y blocks of the chosen I16 mode (raster DCT blocks dct [n, B,
    16, 16], spatial prediction pred) quantized by the trellis under all
    three entry contexts, then resolved block by block in raster order
    from the neighbours' nnz (top_nz, left_nz [n, B, 4]).  Returns (levels
    [n, B, 16, 16], rec [n, B, 16, 16])."""
    lv3, nz3 = trellis_spec3(dct, _ex(P.y1_q, 1), _ex(P.y1_iq, 1), _ex(P.y1_sharpen, 1),
                             P.lambda_trellis_i16[..., None], 1, *_tables(tbl, 0, 1))
    levels, nnz = [None] * 16, [None] * 16
    for bi in range(16):
        y, x = bi // 4, bi % 4
        ctx = ((top_nz[..., x] if y == 0 else nnz[bi - 4])
               + (left_nz[..., y] if x == 0 else nnz[bi - 1])).long()
        levels[bi] = _pick(lv3[:, :, bi], ctx)
        nnz[bi] = _pick(nz3[:, :, bi, :, None], ctx)[..., 0].to(torch.int32)
    y_lv = torch.stack(levels, 2)
    blk = _dequant(y_lv, _ex(P.y1_q, 1))
    blk[..., 0] = iwht4x4(_dequant(y2_lv, P.y2_q))
    return y_lv, (pred + _spatial(idct4x4(blk), 4)).clamp(0, 255)


def _i4_trellis(a16, tr4, tl, left16, src, modes, top_nz, left_nz, P, tbl):
    """The 16 subblocks re-run in order with their modes fixed, each
    trellis-quantized with the entry context of its top and left neighbours'
    nnz (top_nz, left_nz [n, B, 4] across the MB edge) and predicted from
    the trellis reconstruction.  Returns (levels [n, B, 16, 16], rec)."""
    n, B = src.shape[:2]
    src_blocks = _blocks(src, 4)
    ws = _i4_workspace(a16, tr4, tl, left16)
    nnz = torch.zeros((n, B, 5, 5), dtype=torch.int32, device=src.device)  # with the MB halo
    nnz[..., 0, 1:] = top_nz
    nnz[..., 1:, 0] = left_nz
    tables = _tables(tbl, 3, 0)
    levels = []
    for i in range(16):
        sby, sbx = i // 4, i % 4
        pred = _pick(_i4_preds(ws, sby, sbx), modes[..., i])
        ctx = nnz[..., sby, sbx + 1] + nnz[..., sby + 1, sbx]
        lv, has = trellis_par(dct4x4(src_blocks[:, :, i] - pred), P.y1_q, P.y1_iq, P.y1_sharpen,
                              P.lambda_trellis_i4, 0, ctx, *tables)
        rec = (pred + idct4x4(_dequant(lv, P.y1_q))).clamp(0, 255)
        ws[..., sby * 4 + 1 : sby * 4 + 5, sbx * 4 + 1 : sbx * 4 + 5] = rec.reshape(n, B, 4, 4)
        nnz[..., sby + 1, sbx + 1] = has.to(torch.int32)
        levels.append(lv)
    return torch.stack(levels, 2), ws[..., 1:, 1:17]


def _i4_search(a16, tr4, tl, left16, src, tb, lb, i16_score, n_try: int, P, tbl):
    """The 16 subblocks in order over [n, B] lanes.  tb/lb [n, B, 4] are the
    neighbour B-mode contexts.  Returns (ok [n, B], modes [n, B, 16], levels
    [n, B, 16, 16], rec [n, B, 16, 16], tb, lb)."""
    n, B = src.shape[:2]
    dev = src.device
    w, fixed_i4 = _const("weight_y", dev), _const("fixed_i4", dev)
    src_blocks = _blocks(src, 4)
    tsrc_all = _t_transform(src_blocks.reshape(n, B, 16, 4, 4), w)
    ws = _i4_workspace(a16, tr4, tl, left16)
    tb, lb = tb.clone(), lb.clone()
    tnz = torch.zeros((n, B, 4), dtype=torch.int32, device=dev)
    lnz = torch.zeros((n, B, 4), dtype=torch.int32, device=dev)
    rate = torch.full((n, B), 211, dtype=torch.int32, device=dev)  # BMODE initial penalty
    disto = torch.zeros((n, B), dtype=torch.int32, device=dev)
    tmc = torch.zeros((n, B), dtype=torch.int32, device=dev)
    ok = torch.ones((n, B), dtype=torch.bool, device=dev)
    modes, levels = [], []
    for i in range(16):
        sby, sbx = i // 4, i % 4
        src4 = src_blocks[:, :, i]
        preds = _i4_preds(ws, sby, sbx)                            # [n, B, 10, 16]
        sse = ((preds - src4[:, :, None]) ** 2).sum(-1, dtype=torch.int32)
        # DC is always candidate 0; then the least-SSE of modes 1..9, ties
        # to the lower mode.
        kmode = [torch.zeros((n, B), dtype=torch.int64, device=dev)] if n_try < 10 else []
        cur = sse.clone()
        if n_try < 10:
            cur[..., 0] = BIG
        for _ in range(n_try - len(kmode)):
            m = cur.argmin(-1)
            kmode.append(m)
            cur.scatter_(-1, m[..., None], BIG)
        kmode = torch.stack(kmode, dim=-1)                        # [n, B, K]
        cand = torch.gather(preds, 2, kmode[..., None].expand(n, B, n_try, 16))

        lv = _quant(dct4x4(src4[:, :, None] - cand), _ex(P.y1_iq, 1), _ex(P.y1_bias, 1))
        ctx0 = (tnz[..., sbx] if sby > 0 else 0) + (lnz[..., sby] if sbx > 0 else 0)
        ctx0 = torch.as_tensor(ctx0, dtype=torch.int32, device=dev).expand(n, B)
        cc = residual_costs(lv, 3, 0, ctx0[..., None], tbl)
        rec = (cand + idct4x4(_dequant(lv, _ex(P.y1_q, 1)))).clamp(0, 255)
        d = ((rec - src4[:, :, None]) ** 2).sum(-1, dtype=torch.int32)
        trec = _t_transform(rec.reshape(n, B, n_try, 4, 4), w)
        sd = _spectral(_ex(P.tlambda, 1), (trec - tsrc_all[:, :, i, None]).abs() >> 5)
        mc = fixed_i4[((tb[..., sbx] * 10 + lb[..., sby]) * 10)[..., None].long() + kmode]

        rates = cc + mc
        k = rd_score32(rates, d + sd, _ex(P.lambda_i4, 1)).argmin(-1)
        m = _pick(kmode[..., None], k)[..., 0]
        lv_k = _pick(lv, k)
        ws[..., sby * 4 + 1 : sby * 4 + 5, sbx * 4 + 1 : sbx * 4 + 5] = _pick(rec, k).reshape(n, B, 4, 4)
        tb[..., sbx] = m
        lb[..., sby] = m
        has = (lv_k != 0).any(-1).to(torch.int32)
        tnz[..., sbx] = has
        lnz[..., sby] = has
        rate = rate + _pick(rates[..., None], k)[..., 0]
        disto = disto + _pick((d + sd)[..., None], k)[..., 0]
        tmc = tmc + _pick(mc[..., None], k)[..., 0]
        ok = ok & (rd_score32(rate, disto, P.lambda_mode) < i16_score)
        ok = ok & (tmc <= 256 * 16 * 16 // 4)
        modes.append(m.to(torch.int32))
        levels.append(lv_k)
    return ok, torch.stack(modes, -1), torch.stack(levels, 2), ws[..., 1:, 1:17], tb, lb


def _uv_search(a8, left8, tlc, src_c, has_above, has_left, P, tbl):
    """U and V on a channel axis: a8/left8 [n, B, 2, 8], tlc [n, B, 2],
    src_c [n, B, 2, 8, 8] -> (mode [n, B], dct [n, B, 2, 4, 16], pred
    [n, B, 2, 8, 8]) of the best mode."""
    n, B = src_c.shape[:2]
    pred4 = _whole_pred_all4(a8, left8, tlc, has_above[..., None], has_left[..., None], 8)
    dct = dct4x4(_blocks(src_c[:, :, :, None] - pred4, 2))     # [n, B, 2, 4m, 4b, 16]
    lv = _quant(dct, _ex(P.uv_iq, 3), _ex(P.uv_bias, 3))
    rec = (pred4 + _spatial(idct4x4(_dequant(lv, _ex(P.uv_q, 3))), 2)).clamp(0, 255)
    d = ((rec - src_c[:, :, :, None]) ** 2).sum((-1, -2), dtype=torch.int32).sum(-2, dtype=torch.int32)
    lv_m = lv.transpose(2, 3)                                     # [n, B, 4m, 2, 4b, 16]
    rate = _const("fixed_uv", src_c.device) + residual_costs(lv_m, 2, 0, 0, tbl).sum((-1, -2), dtype=torch.int32)
    flat = (lv_m[..., 1:] != 0).sum((-1, -2, -3)) <= 2
    not_dc = torch.arange(4, device=src_c.device) != 0
    rate = torch.where(not_dc & flat, rate + 140 * 8, rate)
    scores = torch.where(_allowed(has_above, has_left, (n, B)),
                         rd_score32(rate, d, _ex(P.lambda_uv, 1)), BIG)
    best = scores.argmin(-1)
    return best, _pick(dct.transpose(2, 3), best), _pick(pred4.transpose(2, 3), best)


def _chroma_diffusion(dct, pred, P, top_err, left_err):
    """Chroma DC error diffusion (C1 = 7, C2 = 8) over [n, B, 2] lanes, then
    the final quantization: dct [n, B, 2, 4, 16], pred [n, B, 2, 8, 8],
    errors [n, B, 2, 2] -> (levels [n, B, 2, 4, 16], rec, new_top, new_left)."""
    q, iq, bias = (getattr(P, f)[..., 0, None] for f in ("uv_q", "uv_iq", "uv_bias"))
    dc = dct[..., 0]

    def diffuse(dcv, t_err, l_err):
        d2 = dcv + ((7 * t_err + 8 * l_err) >> 3)
        a = d2.abs()
        # QuantizeSingle: the coefficient becomes its reconstruction level * q.
        qv = ((a * iq + bias) >> 17) * q
        dcq = torch.where(d2 < 0, -qv, qv)
        err = torch.where(d2 < 0, -(a - qv), a - qv)
        return dcq, (err >> 1).clamp(-127, 127)

    te, le = top_err, left_err
    dc0, e0 = diffuse(dc[..., 0], te[..., 0], le[..., 0])
    dc1, e1 = diffuse(dc[..., 1], te[..., 1], e0)
    dc2, e2 = diffuse(dc[..., 2], e0, le[..., 1])
    dc3, e3 = diffuse(dc[..., 3], e1, e2)
    nl1 = (3 * e3) >> 2
    dct = dct.clone()
    dct[..., 0] = torch.stack([dc0, dc1, dc2, dc3], dim=-1)
    lv = _quant(dct, _ex(P.uv_iq, 2), _ex(P.uv_bias, 2))
    rec = (pred + _spatial(idct4x4(_dequant(lv, _ex(P.uv_q, 2))), 2)).clamp(0, 255)
    return lv, rec, torch.stack([e2, e3 - nl1], -1), torch.stack([e1, nl1], -1)


def _bordered(p: torch.Tensor) -> torch.Tensor:
    """int32 copy [B, H+1, W+1] with the frame border: row 0 is the row above
    the frame (127, its corner included), column 0 the column left of it (129)."""
    B, H, W = p.shape
    w = torch.full((B, H + 1, W + 1), 129, dtype=torch.int32, device=p.device)
    w[:, 0, :] = 127
    return w


def encode_analysis_batch_plain(y, u, v, P: EncParams, tbl: EncTables, n_try: int,
                                do_trellis: bool = False, sid=None):
    """Torch twin of the K5 kernel (any device)."""
    B, H, W = y.shape
    dev = y.device
    mbh, mbw = H // 16, W // 16
    nmb = mbw * mbh
    tbl = tbl.expand(B)
    sid = torch.zeros((B, nmb), dtype=torch.int32, device=dev) if sid is None else sid
    src_y, src_u, src_v = (p.to(torch.int32) for p in (y, u, v))
    Yw, Uw, Vw = _bordered(y), _bordered(u), _bordered(v)
    out = {k: torch.zeros((B, nmb, *s), dtype=torch.int32, device=dev) for k, s in (
        ("luma_mode", ()), ("chroma_mode", ()), ("bpred", (16,)), ("y_levels", (16, 16)),
        ("y2_levels", (16,)), ("uv_levels", (8, 16)))}
    ctx_top = torch.zeros((B, nmb, 4), dtype=torch.int32, device=dev)  # B-mode contexts below
    ctx_left = torch.zeros((B, nmb, 4), dtype=torch.int32, device=dev)  # ... and right of an MB
    err_top = torch.zeros((B, nmb, 2, 2), dtype=torch.int32, device=dev)  # chroma DC diffusion
    err_left = torch.zeros((B, nmb, 2, 2), dtype=torch.int32, device=dev)
    nz_bottom = torch.zeros((B, nmb, 4), dtype=torch.int32, device=dev)  # trellis contexts:
    nz_right = torch.zeros((B, nmb, 4), dtype=torch.int32, device=dev)   # final levels' nnz
    k16, k8, k4 = (torch.arange(k, device=dev) for k in (16, 8, 4))
    # DC/V/H/TM -> B_DC/B_VE/B_HE/B_TM
    bmode_of = torch.tensor([0, 2, 3, 1], dtype=torch.int32, device=dev)
    for t in range(mbw + 2 * (mbh - 1)):
        R = torch.tensor([r for r in range(mbh) if 0 <= t - 2 * r < mbw], dtype=torch.int64,
                         device=dev)
        if len(R) == 0:  # at mbw = 1 every other diagonal is empty
            continue
        X = t - 2 * R
        M = R * mbw + X
        n = len(R)
        has_above, has_left = (R > 0)[:, None], (X > 0)[:, None]

        def lanes(a):  # [B, n, ...] -> [n, B, ...]
            return a.transpose(0, 1)

        PL = P.lanes(lanes(sid[:, M]))
        top, col = (R * 16)[:, None], (X * 16)[:, None]
        a16 = lanes(Yw[:, top, 1 + col + k16])
        tr4 = lanes(Yw[:, top, 1 + (col + 16 + k4).clamp(max=W - 1)])  # rightmost MB repeats a[15]
        tl = lanes(Yw[:, R * 16, X * 16])
        left16 = lanes(Yw[:, 1 + top + k16, col])
        src = lanes(src_y[:, top[:, :, None] + k16[:, None], col[:, :, None] + k16])
        tb0 = torch.where(has_above[..., None], lanes(ctx_top[:, M - mbw]), 0)
        lb0 = torch.where(has_left[..., None], lanes(ctx_left[:, M - 1]), 0)
        tde = torch.where(has_above[..., None, None], lanes(err_top[:, M - mbw]), 0)
        lde = torch.where(has_left[..., None, None], lanes(err_left[:, M - 1]), 0)

        i16_mode, i16_score, i16_y2, i16_y, i16_rec, i16_dct, i16_pred = _i16_search(
            a16, left16, tl, src, has_above, has_left, PL, tbl)
        if n_try > 0:
            use_i4, i4_modes, i4_levels, i4_rec, tb4, lb4 = _i4_search(
                a16, tr4, tl, left16, src, tb0, lb0, i16_score, n_try, PL, tbl)
        else:
            use_i4 = torch.zeros((n, B), dtype=torch.bool, device=dev)
            i4_modes = torch.zeros((n, B, 16), dtype=torch.int32, device=dev)
            i4_levels = i4_rec = torch.zeros((n, B, 16, 16), dtype=torch.int32, device=dev)
            tb4, lb4 = tb0, lb0
        if do_trellis:
            top_nz = torch.where(has_above[..., None], lanes(nz_bottom[:, M - mbw]), 0)
            left_nz = torch.where(has_left[..., None], lanes(nz_right[:, M - 1]), 0)
            i16_y, i16_rec = _i16_trellis(i16_dct, i16_y2, i16_pred, top_nz, left_nz, PL, tbl)
            if n_try > 0:
                i4_levels, i4_rec = _i4_trellis(a16, tr4, tl, left16, src, i4_modes, top_nz,
                                                left_nz, PL, tbl)
        luma_rec = torch.where(use_i4[..., None, None], i4_rec, i16_rec)
        bmode = bmode_of[i16_mode]
        i16_bpred = torch.zeros((n, B, 16), dtype=torch.int32, device=dev)
        i16_bpred[..., 12:] = bmode[..., None]
        u4 = use_i4[..., None]
        y_levels = torch.where(u4[..., None], i4_levels, i16_y)

        ctop, ccol = (R * 8)[:, None], (X * 8)[:, None]
        cplanes = (Uw, Vw)
        a8 = torch.stack([lanes(c[:, ctop, 1 + ccol + k8]) for c in cplanes], 2)
        tlc = torch.stack([lanes(c[:, R * 8, X * 8]) for c in cplanes], 2)
        left8 = torch.stack([lanes(c[:, 1 + ctop + k8, ccol]) for c in cplanes], 2)
        src_c = torch.stack([lanes(s[:, ctop[:, :, None] + k8[:, None], ccol[:, :, None] + k8])
                             for s in (src_u, src_v)], 2)
        uv_mode, uv_dct, uv_pred = _uv_search(a8, left8, tlc, src_c, has_above, has_left, PL, tbl)
        uv_lv, uv_rec, new_tde, new_lde = _chroma_diffusion(uv_dct, uv_pred, PL, tde, lde)

        def store(dst, val):  # [n, B, ...] -> dst[:, M]
            dst[:, M] = val.transpose(0, 1).to(dst.dtype)

        store(out["luma_mode"], torch.where(use_i4, 4, i16_mode))
        store(out["chroma_mode"], uv_mode)
        store(out["bpred"], torch.where(u4, i4_modes, i16_bpred))
        store(out["y_levels"], y_levels)
        store(out["y2_levels"], torch.where(u4, 0, i16_y2))
        store(out["uv_levels"], uv_lv.reshape(n, B, 8, 16))
        store(ctx_top, torch.where(u4, tb4, bmode[..., None]))
        store(ctx_left, torch.where(u4, lb4, bmode[..., None]))
        store(err_top, new_tde)
        store(err_left, new_lde)
        if do_trellis:  # nnz per block of the final levels: from position 1 in I16 MBs
            nz = torch.where(u4, (y_levels != 0).any(-1), (y_levels[..., 1:] != 0).any(-1))
            nz = nz.to(torch.int32).reshape(n, B, 4, 4)
            store(nz_bottom, nz[..., 3, :])
            store(nz_right, nz[..., :, 3])
        Yw[:, 1 + top[:, :, None] + k16[:, None], 1 + col[:, :, None] + k16] = lanes(luma_rec)
        for j, c in enumerate(cplanes):
            c[:, 1 + ctop[:, :, None] + k8[:, None], 1 + ccol[:, :, None] + k8] = lanes(uv_rec[:, :, j])
    return {k: out[k].to(torch.uint8 if k in ("luma_mode", "chroma_mode", "bpred") else torch.int16)
            for k in OUT_FIELDS}

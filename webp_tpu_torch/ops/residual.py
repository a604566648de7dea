"""Kernel K1: coefficient levels -> residual blocks, and the do_sub flags.

Per macroblock: expand the sparse level format (or read dense int16
levels), restore the |level| > 127 escapes, dequantize with the MB's
segment table, inverse-WHT the Y2 block into the Y DCs of non-B MBs, and
inverse-DCT all 24 blocks.

Replaces `webp_tpu/ops/sparse.py:129` `device_expand_levels_mb`, the escape
scatter of `webp_tpu/decode/device.py:466` `_device_decode_sparse8`, and the
dequant / Y2 IWHT / IDCT half of `webp_tpu/decode/device.py:509`
`_decode_core`.  The CUDA kernel is `csrc/residual.cu`; the `*_plain`
functions here are its torch twins, run for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import _build
from .sparse import expand_levels_mb
from .transform import idct4x4, iwht4x4

SLOTS = 400  # 25 blocks x 16 levels per MB (blocks 0-15 Y, 16-23 U/V, 24 Y2)
QTAB = 4 * 25 * 16  # per-image dequant table [segment, block, position]
WARPS = 8  # MBs a K1 CTA takes, one warp each (csrc/residual.cu kWarps)


def scatter_escapes(lv: torch.Tensor, esc_pos: torch.Tensor, esc_val: torch.Tensor):
    """lv int16 [B, n] with lv[b, esc_pos] = esc_val; positions outside
    [0, n) (the unused-slot sentinel n) are dropped."""
    B, n = lv.shape
    buf = torch.cat([lv, lv.new_zeros((B, 1))], dim=1)
    pos = esc_pos.to(torch.int64)
    pos = torch.where((pos < 0) | (pos >= n), torch.full_like(pos, n), pos)
    buf.scatter_(1, pos, esc_val.to(torch.int16))
    return buf[:, :n]


def dequant_fold_idct(levels, qtab, seg, lmode, skipped, non_zero):
    """levels int16 [B, nmb, 25, 16], qtab [B, 1600] -> (residuals int32
    [B, nmb, 24, 16], do_sub bool [B, nmb])."""
    B = levels.shape[0]
    q = qtab.reshape(B, 4, 25, 16).to(torch.int32)
    qm = q[torch.arange(B, device=q.device)[:, None], seg.to(torch.int64)]
    deq = levels.to(torch.int32) * qm
    y2 = iwht4x4(deq[:, :, 24])
    lm = lmode.to(torch.int32)
    coeffs = deq[:, :, :24].clone()
    coeffs[:, :, :16, 0] = torch.where((lm != 4)[..., None], y2, deq[:, :, :16, 0])
    do_sub = (lm == 4) | (~skipped.bool() & non_zero.bool())
    return idct4x4(coeffs), do_sub


def residuals_sparse_plain(bitmap, vals, esc_pos, esc_val, qtab, seg, lmode, skipped, non_zero):
    B, nmb = seg.shape
    lv = expand_levels_mb(bitmap, vals, nmb, SLOTS).reshape(B, nmb * SLOTS)
    lv = scatter_escapes(lv, esc_pos, esc_val)
    return dequant_fold_idct(lv.reshape(B, nmb, 25, 16), qtab, seg, lmode, skipped, non_zero)


def residuals_dense_plain(i16buf, seg, lmode, skipped, non_zero):
    B, nmb = seg.shape
    levels = i16buf[:, : nmb * SLOTS].reshape(B, nmb, 25, 16)
    return dequant_fold_idct(levels, i16buf[:, nmb * SLOTS :], seg, lmode, skipped, non_zero)


def _launch(dev, level_args, seg, lmode, skipped, non_zero):
    """Launch K1; level_args = the sparse, dense and qtab arguments of
    `webp_residual` (pointers and strides, null/0 for the unused form)."""
    B, nmb = seg.shape
    res = torch.empty((B, nmb, 24, 16), dtype=torch.int32, device=dev)
    do_sub = torch.empty((B, nmb), dtype=torch.bool, device=dev)
    fields = []
    for f in (seg, lmode, skipped, non_zero):
        fields += _build.mb_field(f, B, nmb)
    _build.launch("residual", "webp_residual", dev, *level_args, *fields, nmb, B,
                  res.data_ptr(), do_sub.data_ptr())
    return res, do_sub


def residuals_sparse(bitmap, vals, esc_pos, esc_val, qtab, seg, lmode, skipped, non_zero):
    """Sparse levels (bitmap [B, nmb*50] uint8, vals [B, nmb, cap] int8) plus
    the per-image escape list (esc_pos int32 / esc_val int16 [B, n_esc]) ->
    (residuals int32 [B, nmb, 24, 16], do_sub bool [B, nmb]).

    esc_pos must ascend within each image, unused slots holding nmb*400 at
    the end, as `decode.device.parse_levels_batch` writes it: the kernel
    finds an MB's escapes by a 32-ary search.
    """
    dev = _build.same_device(bitmap, vals, esc_pos, esc_val, qtab, seg, lmode, skipped, non_zero)
    if dev.type == "cpu":
        return residuals_sparse_plain(bitmap, vals, esc_pos, esc_val, qtab, seg, lmode,
                                      skipped, non_zero)
    B, nmb = seg.shape
    cap = vals.shape[-1]
    n_esc = esc_pos.shape[-1]
    if qtab.dtype != torch.int16 or tuple(qtab.shape) != (B, QTAB) or qtab.stride(1) != 1:
        raise ValueError(f"qtab must be int16 {(B, QTAB)} with packed rows")
    level_args = (
        _build.dense(bitmap, torch.uint8, (B, nmb * SLOTS // 8)),
        _build.dense(vals, torch.int8, (B, nmb, cap)), cap,
        _build.dense(esc_pos, torch.int32, (B, n_esc)),
        _build.dense(esc_val, torch.int16, (B, n_esc)), n_esc,
        None, 0,                            # no dense levels
        qtab.data_ptr(), qtab.stride(0),
    )
    return _launch(dev, level_args, seg, lmode, skipped, non_zero)


def residuals_dense(i16buf, seg, lmode, skipped, non_zero):
    """Dense int16 levels then qtab, i16buf [B, nmb*400 + 1600] -> as
    `residuals_sparse` (the path for images that overflow the sparse format
    or the escape budget)."""
    dev = _build.same_device(i16buf, seg, lmode, skipped, non_zero)
    if dev.type == "cpu":
        return residuals_dense_plain(i16buf, seg, lmode, skipped, non_zero)
    B, nmb = seg.shape
    if (i16buf.dtype != torch.int16 or tuple(i16buf.shape) != (B, nmb * SLOTS + QTAB)
            or i16buf.stride(1) != 1):
        raise ValueError(f"i16buf must be int16 {(B, nmb * SLOTS + QTAB)} with packed rows")
    row = i16buf.stride(0)
    level_args = (
        None, None, 0, None, None, 0,       # no sparse levels
        i16buf.data_ptr(), row,
        i16buf.data_ptr() + nmb * SLOTS * i16buf.element_size(), row,  # qtab tail
    )
    return _launch(dev, level_args, seg, lmode, skipped, non_zero)

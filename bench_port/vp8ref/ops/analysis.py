"""Frozen copy of the plain code of `webp_tpu_torch/ops/analysis.py`, the
benchmark's reference; it imports nothing of the port.

Kernel K8: the segment analysis, per-MB alphas for the k-means segments.

Replaces `webp_tpu/ops/analysis2.py:128` `analyze_alphas_batch` (with
`_dct4x4` :27, `_alphas_from_coeffs` :54 and `_dc_tm_preds` :107).  Each MB
is predicted from its source neighbours (127 above the frame, 129 left of
it) by DC and TrueMotion, the residuals go through libwebp's analysis DCT,
and a 32-bin histogram of min(|coeff| >> 3, 31) gives each mode's alpha;
luma and chroma keep their better mode.

`analyze_alphas_batch_plain` is the plain torch form (any device).
"""

from __future__ import annotations

import torch

from .encode_wavefront import _blocks

MAX_ALPHA = 255
ALPHA_SCALE = 2 * MAX_ALPHA
MAX_COEFF_THRESH = 31


def _analysis_dct(d):
    """libwebp analysis FTransform of [..., 4, 4] int32 residuals."""
    d0, d1, d2, d3 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    a0, a1, a2, a3 = d0 + d3, d1 + d2, d1 - d2, d0 - d3
    t = torch.stack([(a0 + a1) * 8, (a2 * 2217 + a3 * 5352 + 1812) >> 9, (a0 - a1) * 8,
                     (a3 * 2217 - a2 * 5352 + 937) >> 9], dim=-1)
    c0, c1, c2, c3 = t[..., 0, :], t[..., 1, :], t[..., 2, :], t[..., 3, :]
    a0, a1, a2, a3 = c0 + c3, c1 + c2, c1 - c2, c0 - c3
    return torch.stack([(a0 + a1 + 7) >> 4,
                        ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0).to(torch.int32),
                        (a0 - a1 + 7) >> 4, (a3 * 2217 - a2 * 5352 + 51000) >> 16], dim=-2)


def _alphas(coeffs):
    """[B, nmb, n] coefficients -> per-MB histogram alpha [B, nmb] int32."""
    v = (coeffs.to(torch.int32).abs() >> 3).clamp_max(MAX_COEFF_THRESH)
    hist = torch.zeros((*v.shape[:-1], MAX_COEFF_THRESH + 1), dtype=torch.int32,
                       device=v.device)
    hist.scatter_add_(-1, v.long(), torch.ones_like(v))
    max_value = hist.amax(-1)
    bins = torch.arange(MAX_COEFF_THRESH + 1, dtype=torch.int32, device=v.device)
    last_nz = torch.where(hist > 0, bins, -1).amax(-1)
    last_nz = torch.where(last_nz >= 0, last_nz, 1)
    return torch.where(max_value > 1, ALPHA_SCALE * last_nz // max_value.clamp_min(1), 0)


def _dc_tm_preds(plane, mbh: int, mbw: int, size: int):
    """DC and TM predictions [B, nmb, size, size] of every MB from source
    borders (127 above the frame, 129 left of it)."""
    B, H, W = plane.shape
    padded = torch.full((B, H + 1, W + 1), 129, dtype=torch.int32, device=plane.device)
    padded[:, 0] = 127
    padded[:, 1:, 1:] = plane
    top = padded[:, 0:H:size, 1:].reshape(B, mbh, mbw, size).reshape(B, -1, size)
    left = padded[:, 1:, 0:W:size].reshape(B, mbh, size, mbw).transpose(2, 3).reshape(B, -1, size)
    corner = padded[:, 0:H:size, 0:W:size].reshape(B, -1)
    gy, gx = torch.meshgrid(torch.arange(mbh, device=plane.device),
                            torch.arange(mbw, device=plane.device), indexing="ij")
    ht, hl = (gy > 0).reshape(-1).to(torch.int32), (gx > 0).reshape(-1).to(torch.int32)
    shift = (2 if size == 8 else 3) + ht + hl
    total = left.sum(-1) * hl + top.sum(-1) * ht
    dc = torch.where((ht + hl) > 0, (total + (1 << (shift - 1).clamp_min(0))) >> shift, 0x80)
    dc_pred = dc.to(torch.int32)[..., None, None].expand(B, mbh * mbw, size, size)
    tm = (left[..., :, None] + top[..., None, :] - corner[..., None, None]).clamp(0, 255)
    return dc_pred, tm


def _mb_tiles(plane, mbh: int, mbw: int, size: int):
    """[B, mbh*size, mbw*size] -> [B, nmb, size, size]."""
    B = plane.shape[0]
    return plane.reshape(B, mbh, size, mbw, size).transpose(2, 3).reshape(B, -1, size, size)


def analyze_alphas_batch_plain(y, u, v):
    """Torch twin of the K8 kernel (any device)."""
    B, H, W = y.shape
    mbh, mbw = H // 16, W // 16
    nmb = mbh * mbw
    planes = [p.to(torch.int32) for p in (y, u, v)]

    def alpha_of(srcs_preds, n):  # n: 4x4 blocks per side of an MB's plane
        best = None
        for pairs in srcs_preds:
            coeffs = torch.cat([_analysis_dct(_blocks(s - p, n).reshape(B, nmb, -1, 4, 4))
                                .reshape(B, nmb, -1) for s, p in pairs], dim=-1)
            a = _alphas(coeffs)
            best = a if best is None else torch.maximum(best, a)
        return best

    ysrc = _mb_tiles(planes[0], mbh, mbw, 16)
    best_y = alpha_of([[(ysrc, p)] for p in _dc_tm_preds(planes[0], mbh, mbw, 16)], 4)
    csrc = [_mb_tiles(p, mbh, mbw, 8) for p in planes[1:]]
    cpred = [_dc_tm_preds(p, mbh, mbw, 8) for p in planes[1:]]
    best_uv = alpha_of([[(csrc[0], cpred[0][m]), (csrc[1], cpred[1][m])] for m in range(2)], 2)
    alpha = (3 * best_y + best_uv + 2) >> 2
    final = (MAX_ALPHA - alpha).clamp(0, MAX_ALPHA).to(torch.int32)
    return final, (best_uv.sum(-1, dtype=torch.int64) // nmb).to(torch.int32)


# ---- the kernel's schedule ---------------------------------------------------

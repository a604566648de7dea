"""Kernel K8: the segment analysis, per-MB alphas for the k-means segments.

Replaces `webp_tpu/ops/analysis2.py:128` `analyze_alphas_batch` (with
`_dct4x4` :27, `_alphas_from_coeffs` :54 and `_dc_tm_preds` :107).  Each MB
is predicted from its source neighbours (127 above the frame, 129 left of
it) by DC and TrueMotion, the residuals go through libwebp's analysis DCT,
and a 32-bin histogram of min(|coeff| >> 3, 31) gives each mode's alpha;
luma and chroma keep their better mode.

`analyze_alphas_batch` launches the CUDA kernel (`csrc/analysis.cu`) for
CUDA tensors and runs the plain torch twin `analyze_alphas_batch_plain`
for CPU ones.  `analyze_alphas_rows_plain` is the twin of the kernel's
schedule: CTAs of one MB row's run of MBs over staged pixel tiles, MBs two
at a time in three rounds of 32 lanes with per-lane counts summed per bin,
and the images' chroma sums finished by each image's last CTA.
"""

from __future__ import annotations

import torch

from .. import _build
from .encode_wavefront import _blocks

# MBs a CTA of the kernel takes from one MB row (at most csrc/analysis.cu's
# kSeg = 64): 16 was the fastest of 8-64 at batch 8 and 64, 768x512 on an
# H100 (tools/stats_split.py --segs).
SEG_MBS = 16
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


def analyze_alphas_batch(y, u, v):
    """Per-MB alphas of a batch of padded YUV420 planes y [B, mbh*16,
    mbw*16], u/v [B, mbh*8, mbw*8] uint8: (final_alpha [B, nmb] int32,
    uv_alpha [B] int32), on the planes' device."""
    dev = _build.same_device(y, u, v)
    if dev.type == "cpu":
        return analyze_alphas_batch_plain(y, u, v)
    return _analysis_kernel(y, u, v, SEG_MBS)


def _analysis_kernel(y, u, v, seg: int):
    """One launch of K8 with CTAs of `seg` MBs (1..64) of an MB row."""
    dev = y.device
    B, H, W = y.shape
    mbh, mbw = H // 16, W // 16
    alpha = torch.empty((B, mbh * mbw), dtype=torch.int32, device=dev)
    uv_alpha = torch.empty(B, dtype=torch.int32, device=dev)
    acc = _build.kept_zeroed("analysis", 2 * B, torch.int64, dev)
    _build.launch("analysis", "webp_analysis", dev, *_build.plane(y, B, H, W),
                  *_build.plane(u, B, H // 2, W // 2), *_build.plane(v, B, H // 2, W // 2),
                  mbw, mbh, B, seg, alpha.data_ptr(), uv_alpha.data_ptr(), acc.data_ptr())
    return alpha, uv_alpha


# ---- the kernel's schedule ---------------------------------------------------


def _stage(plane, my: int, x0: int, n: int, size: int):
    """A CTA's staged tile [size + 1, 1 + n * size] of an image's plane: the
    row above the MB row (127 above the frame, the corner included), then
    its rows; column 0 is the column left of the run (129 left of the frame)."""
    tile = torch.full((size + 1, 1 + n * size), 129, dtype=torch.int32)
    for r in range(size + 1):
        gy = my * size - 1 + r
        if gy < 0:
            tile[r] = 127
            continue
        tile[r, 1:] = plane[gy, x0 * size:(x0 + n) * size]
        if x0 > 0:
            tile[r, 0] = plane[gy, x0 * size - 1]
    return tile


def _lane_blocks(tiles, plane, cols, n4: int, tm, dc):
    """Residual blocks [32, 4, 4] of 32 lanes: lane l's is the 4x4 block
    l % (n4 * n4) (raster) of the MB whose first column is cols[l] in tile
    tiles[plane[l]], under TM where tm[l], else DC dc[l]."""
    blk = torch.arange(32) % (n4 * n4)
    r = ((blk // n4) * 4)[:, None, None] + torch.arange(4)[None, :, None]
    c = ((blk % n4) * 4)[:, None, None] + torch.arange(4)[None, None, :]
    org, p = cols[:, None, None], plane[:, None, None]
    src = tiles[p, 1 + r, org + c]
    pred = (tiles[p, 1 + r, org - 1] + tiles[p, 0, org + c] - tiles[p, 0, org - 1]).clamp(0, 255)
    return src - torch.where(tm[:, None, None], pred, dc[:, None, None])


def _round_alphas(tiles, plane, cols, n4: int, tm, dc, counted, width: int):
    """One 32-lane round: each counted lane adds its block's 16 bins to its
    column of a [32 bins, 32 lanes] tile, lane b sums row b over each group
    of `width` lanes; the groups' alphas."""
    coef = _analysis_dct(_lane_blocks(tiles, plane, cols, n4, tm, dc)).reshape(32, 16)
    bins = (coef.abs() >> 3).clamp_max(MAX_COEFF_THRESH)
    cnt = torch.zeros((32, 32), dtype=torch.int32)
    lanes = torch.arange(32)[:, None].expand(32, 16)
    ones = counted[:, None].expand(32, 16).to(torch.int32)
    cnt.index_put_((bins.reshape(-1), lanes.reshape(-1)), ones.reshape(-1), accumulate=True)
    out = []
    for g in range(32 // width):
        sums = cnt[:, g * width:(g + 1) * width].sum(1)
        mx = int(sums.max())
        nz = torch.nonzero(sums > 0)
        last = int(nz.max()) if len(nz) else 1
        out.append(ALPHA_SCALE * last // mx if mx > 1 else 0)
    return out


def _dc(total: int, above: bool, left: bool, log2n: int) -> int:
    if not (above or left):
        return 128
    shf = log2n - 1 + above + left
    return (total + (1 << (shf - 1))) >> shf


def analyze_alphas_rows_plain(y, u, v, seg: int = SEG_MBS, order=None, sums=None):
    """Twin of the K8 kernel's schedule (CPU).  CTAs (image, MB row, run of
    <= seg MBs), in `order` (indices into their list in (image, row, run)
    order; all in order by default), each over its staged tiles: MBs two at
    a time, the first's luma (lane = mode * 16 + block), the second's, then
    both chromas (lane = MB * 16 + mode * 8 + plane * 4 + block), each MB's
    DC from its neighbour row and column; per image a chroma sum and a
    ticket, the image's last CTA writing floor(sum / nmb) and resetting both
    (and, where `sums` is a dict, the sum at sums[image])."""
    B, H, W = y.shape
    mbh, mbw = H // 16, W // 16
    nseg = -(-mbw // seg)
    ctas = [(b, my, s) for b in range(B) for my in range(mbh) for s in range(nseg)]
    if order is not None:
        ctas = [ctas[i] for i in order]
    planes = [p.cpu().to(torch.int32) for p in (y, u, v)]
    alpha = torch.full((B, mbh * mbw), -1, dtype=torch.int32)
    uv_alpha = torch.full((B,), -1, dtype=torch.int32)
    acc = [[0, 0] for _ in range(B)]
    lanes = torch.arange(32)
    for b, my, s in ctas:
        x0 = s * seg
        n = min(seg, mbw - x0)
        ys = _stage(planes[0][b], my, x0, n, 16)
        cs = [_stage(p[b], my, x0, n, 8) for p in planes[1:]]
        above = my > 0
        part = 0
        for i0 in range(0, n, 2):
            has2 = i0 + 1 < n
            best_y = []
            for i in range(i0, i0 + 1 + has2):
                left = x0 + i > 0
                org = 1 + i * 16
                nb = torch.where(lanes < 16, ys[0, org + lanes % 16] * above,
                                 ys[1 + lanes % 16, org - 1] * left)
                dc = _dc(int(nb.sum()), above, left, 4)
                a = _round_alphas(ys[None], lanes * 0, torch.full((32,), org), 4, lanes >= 16,
                                  torch.full((32,), dc), torch.ones(32, dtype=torch.bool), 16)
                best_y.append(max(a))
            # Chroma: the DC of (MB, plane) from the 8-lane segment lane >> 3.
            seg_dc = torch.zeros(32, dtype=torch.int32)
            for k in range(4):
                sm, sp = k >> 1, k & 1
                if sm and not has2:
                    continue
                org = 1 + (i0 + sm) * 8
                left = x0 + i0 + sm > 0
                total = int(cs[sp][0, org:org + 8].sum()) * above
                total += int(cs[sp][1:9, org - 1].sum()) * left
                seg_dc[8 * k:8 * k + 8] = _dc(total, above, left, 3)
            mb, mode, plane = lanes >> 4, (lanes >> 3) & 1, (lanes >> 2) & 1
            dc = seg_dc[(mb << 4) | (plane << 3)]
            live = (mb == 0) | has2  # the lanes of a missing second MB count nothing
            a = _round_alphas(torch.stack(cs), plane, torch.where(live, 1 + (i0 + mb) * 8, 1), 2,
                              mode == 1, dc, live, 8)
            best_uv = [max(a[0], a[1]), max(a[2], a[3])]
            for j in range(1 + has2):
                m = my * mbw + x0 + i0 + j
                a = (3 * best_y[j] + best_uv[j] + 2) >> 2
                alpha[b, m] = max(0, min(MAX_ALPHA, MAX_ALPHA - a))
                part += best_uv[j]
        acc[b][0] += part
        acc[b][1] += 1
        if acc[b][1] == mbh * nseg:
            uv_alpha[b] = acc[b][0] // (mbh * mbw)
            if sums is not None:
                sums[b] = acc[b][0]
            acc[b] = [0, 0]
    return alpha, uv_alpha

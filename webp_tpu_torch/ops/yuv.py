"""Kernel K4: fancy chroma upsampling + YUV -> RGB (libwebp fixed point).

Replaces `webp_tpu/ops/jax_ops.py:189` `fancy_yuv420_to_rgb` (with
`fancy_upsample` :149 and `yuv_to_rgb` :139).  The CUDA kernel is
`csrc/yuv2rgb.cu`; `fancy_yuv420_to_rgb_plain` is its torch twin.
`simple_yuv420_to_rgb`, the decoder API's `upsampling="simple"`, runs on
the host, as in the JAX package (`webp_tpu/ops/yuv.py:59`).

The encoder API's colour conversions run on the host too, in numpy
float32 as in the JAX package (`webp_tpu/ops/yuv.py:142-252`), since
another summation order moves the rounded chroma and the bytes with it:
`rgb_to_yuv420_sharp` (the least-squares chroma refinement of the PHOTO
and PICTURE presets, over the C++ `rgb_to_yuv420`) and `gray_to_yuv420`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..io import native


def _mulhi(v: torch.Tensor, coeff: int) -> torch.Tensor:
    return (v * coeff) >> 8


def yuv_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-pixel planes -> RGB [..., 3] uint8."""
    y, u, v = (t.to(torch.int32) for t in (y, u, v))
    yv = _mulhi(y, 19077)
    r = yv + _mulhi(v, 26149) - 14234
    g = yv - _mulhi(u, 6419) - _mulhi(v, 13320) + 8708
    b = yv + _mulhi(u, 33050) - 17685
    return (torch.stack([r, g, b], dim=-1) >> 6).clamp(0, 255).to(torch.uint8)


def _far(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Upsampled "far" neighbour along `dim`: output 2k reads in[k-1], output
    2k+1 reads in[k+1], mirrored at the edges."""
    dim = dim % a.ndim
    n = a.shape[dim]
    prev = torch.cat([a.narrow(dim, 0, 1), a.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([a.narrow(dim, 1, n - 1), a.narrow(dim, n - 1, 1)], dim)
    return torch.stack([prev, nxt], dim + 1).flatten(dim, dim + 1)


def _near(a: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.repeat_interleave(a, 2, dim=dim)


def fancy_upsample(c: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear 9:3:3:1 upsampling [..., ch, cw] -> int32 [..., height, width]."""
    ci = c.to(torch.int32)
    main = _near(_near(ci, -2), -1)
    sec_col = _far(_near(ci, -2), -1)
    sec_row = _near(_far(ci, -2), -1)
    tert = _far(_far(ci, -2), -1)
    out = (9 * main + 3 * sec_col + 3 * sec_row + tert + 8) >> 4
    return out[..., :height, :width]


def fancy_yuv420_to_rgb_plain(y, u, v, width: int, height: int) -> torch.Tensor:
    ch, cw = (height + 1) // 2, (width + 1) // 2
    uu = fancy_upsample(u[..., :ch, :cw], height, width)
    vv = fancy_upsample(v[..., :ch, :cw], height, width)
    return yuv_to_rgb(y[..., :height, :width], uu, vv)


def simple_yuv420_to_rgb(ybuf: np.ndarray, ubuf: np.ndarray, vbuf: np.ndarray, width: int,
                         height: int) -> np.ndarray:
    """MB-padded host planes -> RGB [height, width, 3] uint8 numpy, each
    chroma sample repeated over its 2x2 pixels (no filtering)."""
    rows, cols = np.arange(height) // 2, np.arange(width) // 2
    planes = (ybuf[:height, :width], ubuf[rows][:, cols], vbuf[rows][:, cols])
    return yuv_to_rgb(*(torch.from_numpy(np.ascontiguousarray(p)) for p in planes)).numpy()


RUN = 8  # output columns a K4 thread takes, in two rows (csrc/yuv2rgb.cu kRun)


def fancy_yuv420_to_rgb(y, u, v, width: int, height: int) -> torch.Tensor:
    """MB-padded planes y [B, mbh*16, mbw*16], u/v [B, mbh*8, mbw*8] uint8
    -> RGB [B, height, width, 3] uint8."""
    dev = _build.same_device(y, u, v)
    if dev.type == "cpu":
        return fancy_yuv420_to_rgb_plain(y, u, v, width, height)
    B, yh, yw = y.shape
    mbh, mbw = yh // 16, yw // 16
    if not (0 < width <= yw and 0 < height <= yh):
        raise ValueError(f"crop {width}x{height} outside planes {yw}x{yh}")
    args = []
    for t, n in ((y, 16), (u, 8), (v, 8)):
        args += _build.plane(t, B, mbh * n, mbw * n)
    rgb = torch.empty((B, height, width, 3), dtype=torch.uint8, device=dev)
    _build.launch("yuv2rgb", "webp_yuv2rgb", dev, *args, mbw, mbh, width, height, B,
                  rgb.data_ptr())
    return rgb


# -- encoder side, host numpy ------------------------------------------------

YUV_FIX = 16


def _up1d(c, N):
    """1-D (3*main + far) half-to-full upsample along the last axis
    (unnormalized; the 2-D caller divides by 16 after both axes)."""
    n = c.shape[-1]
    out = np.empty((*c.shape[:-1], N), np.float32)
    ne = (N + 1) // 2  # even outputs: far = c[max(k-1, 0)]
    far_e = np.concatenate([c[..., :1], c[..., : ne - 1]], axis=-1)
    out[..., 0::2] = 3.0 * c[..., :ne] + far_e
    no = N // 2  # odd outputs: far = c[min(k+1, n-1)]
    if no:
        far_o = c[..., np.minimum(np.arange(no) + 1, n - 1)]
        out[..., 1::2] = 3.0 * c[..., :no] + far_o
    return out


def _fancy_upsample_f(c, height, width):
    """Float version of the decoder's 9:3:3:1 upsample (for sharp-YUV);
    separable: [3,1] per axis, /16 once."""
    return _up1d(_up1d(c, width).T, height).T / 16.0


def _adj1d(y, c):
    """1-D adjoint of the (3*main + 1*far)/4 half-to-full upsample along the
    last axis: y [..., N] -> [..., c]. The 2-D 9:3:3:1 filter is the outer
    product of this kernel with itself, so the 2-D adjoint applies this per
    axis (slice sums only — no scatters)."""
    N = y.shape[-1]
    ye = y[..., 0::2]
    yo = y[..., 1::2]
    out = np.zeros((*y.shape[:-1], c), np.float32)
    out += 3.0 * ye[..., :c]
    out[..., : yo.shape[-1]] += 3.0 * yo
    out[..., : max(ye.shape[-1] - 1, 0)] += ye[..., 1:]   # far: even i -> k=i/2-1
    out[..., 1:] += yo[..., : c - 1]                      # far: odd i -> k=(i-1)/2+1
    out[..., 0] += ye[..., 0]                             # clip at left edge
    if N % 2 == 0 and N >= 2:
        out[..., c - 1] += yo[..., -1]                    # clip at right edge
    return out


def _fancy_adjoint(res, ch, cw):
    """Adjoint of the 9:3:3:1 upsample: full-res [h, w] -> chroma [ch, cw]."""
    return _adj1d(_adj1d(res, cw).T, ch).T


def _fancy_adjoint_weights(h, w, ch, cw):
    """Per-cell adjoint weight totals (for a normalized Jacobi step)."""
    wgt = _fancy_adjoint(np.ones((h, w)), ch, cw)
    return np.maximum(wgt, 1.0)


def rgb_to_yuv420_sharp(rgb: np.ndarray, iters: int = 4):
    """Sharp-YUV RGB->YUV420: least-squares chroma refinement against the
    decoder's fancy upsampler.

    The decoder reconstructs chroma with the known linear 9:3:3:1 operator F;
    standard 2x2 averaging minimizes nothing in that metric. Starting from
    the averaged planes, Jacobi iterations U += F^T(u_full - F U) / colsum(F)
    pull the upsampled chroma toward the per-pixel BT.601 chroma targets
    (sharper chroma edges, higher decoded-RGB PSNR at the same bitstream
    cost model). Same output contract as the C++ `rgb_to_yuv420`."""
    h, w = rgb.shape[:2]
    y, u0, v0 = native.rgb_to_yuv420(rgb)
    r = rgb[:, :, 0].astype(np.int64)
    g = rgb[:, :, 1].astype(np.int64)
    b = rgb[:, :, 2].astype(np.int64)
    u_full = ((-9719 * r - 19081 * g + 28800 * b + (128 << YUV_FIX))
              / float(1 << YUV_FIX)).astype(np.float32)
    v_full = ((28800 * r - 24116 * g - 4684 * b + (128 << YUV_FIX))
              / float(1 << YUV_FIX)).astype(np.float32)

    ch, cw = (h + 1) // 2, (w + 1) // 2

    wgt = _fancy_adjoint_weights(h, w, ch, cw)

    def refine(c_init, target):
        c = c_init[:ch, :cw].astype(np.float32)
        for _ in range(iters):
            res = target - _fancy_upsample_f(c, h, w)
            c = c + _fancy_adjoint(res, ch, cw) / wgt
        return np.clip(np.round(c), 0, 255).astype(np.uint8)

    u = refine(u0, u_full)
    v = refine(v0, v_full)

    mbw = (w + 15) // 16
    mbh = (h + 15) // 16

    def pad(plane, ph, pw):
        out = np.empty((ph, pw), np.uint8)
        sh, sw = plane.shape
        out[:sh, :sw] = plane
        if sw < pw:
            out[:sh, sw:] = plane[:, sw - 1 : sw]
        if sh < ph:
            out[sh:, :] = out[sh - 1 : sh, :]
        return out

    return y, pad(u, mbh * 8, mbw * 8), pad(v, mbh * 8, mbw * 8)


def gray_to_yuv420(gray: np.ndarray):
    """L8/LA8 path: luma copied directly, chroma flat 127."""
    h, w = gray.shape[:2]
    mbw = (w + 15) // 16
    mbh = (h + 15) // 16
    y = np.empty((mbh * 16, mbw * 16), np.uint8)
    y[:h, :w] = gray if gray.ndim == 2 else gray[:, :, 0]
    y[:h, w:] = y[:h, w - 1 : w]
    y[h:, :] = y[h - 1 : h, :]
    u = np.full((mbh * 8, mbw * 8), 127, np.uint8)
    return y, u, u.copy()

"""Kernel K4: fancy chroma upsampling + YUV -> RGB (libwebp fixed point).

Replaces `webp_tpu/ops/jax_ops.py:189` `fancy_yuv420_to_rgb` (with
`fancy_upsample` :149 and `yuv_to_rgb` :139).  The CUDA kernel is
`csrc/yuv2rgb.cu`; `fancy_yuv420_to_rgb_plain` is its torch twin.
`simple_yuv420_to_rgb`, the decoder API's `upsampling="simple"`, runs on
the host, as in the JAX package (`webp_tpu/ops/yuv.py:59`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build


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

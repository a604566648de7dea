"""Frozen copy of `webp_tpu/ops/yuv.py` (numpy), part of the
benchmark's reference decoder; `src/` paths name the Rust reference codec's
sources.

YUV420 -> RGB conversion with libwebp fixed-point math and fancy (bilinear)
or simple chroma upsampling, as whole-image numpy gathers.

Parity: `src/decoder/yuv.rs:36-431`. The reference walks row
pairs sharing chroma rows; here the same weights are expressed as a closed-form
per-pixel gather (main/secondary row/col + 9:3:3:1 weights), which is also the
shape of the JAX/Pallas device kernel.
"""

from __future__ import annotations

import numpy as np


def _mulhi(v, coeff):
    return (v.astype(np.int64) * coeff) >> 8


def yuv_to_rgb(y, u, v):
    """Per-pixel planes [h, w] uint8 -> RGB [h, w, 3] uint8."""
    yv = _mulhi(y, 19077)
    r = yv + _mulhi(v, 26149) - 14234
    g = yv - _mulhi(u, 6419) - _mulhi(v, 13320) + 8708
    b = yv + _mulhi(u, 33050) - 17685
    out = np.stack([r, g, b], axis=-1) >> 6
    return np.clip(out, 0, 255).astype(np.uint8)


def _fancy_upsample(c, height, width):
    """Upsample a chroma plane [ch, cw] to [height, width] with 9:3:3:1."""
    ch, cw = c.shape
    r = np.arange(height)
    x = np.arange(width)
    mr = r // 2
    fr = np.clip(np.where(r % 2 == 1, r // 2 + 1, r // 2 - 1), 0, ch - 1)
    mc = x // 2
    fc = np.clip(np.where(x % 2 == 1, x // 2 + 1, x // 2 - 1), 0, cw - 1)

    c32 = c.astype(np.uint16)
    main = c32[mr][:, mc]
    sec_col = c32[mr][:, fc]
    sec_row = c32[fr][:, mc]
    tert = c32[fr][:, fc]
    return ((9 * main.astype(np.uint32) + 3 * sec_col + 3 * sec_row + tert + 8) >> 4).astype(
        np.uint8
    )


def fancy_yuv420_to_rgb(ybuf, ubuf, vbuf, width, height):
    """Decode-side conversion; ybuf is the padded [mbh*16, mbw*16] plane."""
    y = ybuf[:height, :width]
    chroma_h = (height + 1) // 2
    chroma_w = (width + 1) // 2
    u = _fancy_upsample(ubuf[:chroma_h, :chroma_w], height, width)
    v = _fancy_upsample(vbuf[:chroma_h, :chroma_w], height, width)
    return yuv_to_rgb(y, u, v)


def simple_yuv420_to_rgb(ybuf, ubuf, vbuf, width, height):
    y = ybuf[:height, :width]
    rows = (np.arange(height)) // 2
    cols = (np.arange(width)) // 2
    u = ubuf[rows][:, cols]
    v = vbuf[rows][:, cols]
    return yuv_to_rgb(y, u, v)

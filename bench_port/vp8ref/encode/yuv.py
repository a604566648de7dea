"""RGB -> padded YUV420, the encode's colour conversion in numpy.

Frozen copy of `webp_tpu/ops/yuv.py` `rgb_to_yuv420_numpy`, the equality
oracle of the port's C++ `rgb_to_yuv420`: BT.601 fixed point with libwebp's
coefficients, 2x2 chroma averaging and edge-replicated padding to whole MBs.
"""

from __future__ import annotations

import numpy as np

YUV_FIX = 16
YUV_HALF = 1 << (YUV_FIX - 1)


def rgb_to_yuv420(rgb: np.ndarray):
    """[h, w, 3|4] uint8 -> (y [mbh*16, mbw*16], u, v [mbh*8, mbw*8]) uint8."""
    h, w = rgb.shape[:2]
    mbw, mbh = (w + 15) // 16, (h + 15) // 16
    r, g, b = (rgb[:, :, c].astype(np.int32) for c in range(3))
    y = ((16839 * r + 33059 * g + 6420 * b + YUV_HALF + (16 << YUV_FIX)) >> YUV_FIX).astype(np.uint8)
    u_raw = -9719 * r - 19081 * g + 28800 * b + (128 << YUV_FIX)
    v_raw = 28800 * r - 24116 * g - 4684 * b + (128 << YUV_FIX)
    ew, eh = w + (w & 1), h + (h & 1)

    def downsample(raw):
        full = np.empty((eh, ew), np.int64)
        full[:h, :w] = raw
        if w & 1:
            full[:h, w] = raw[:, w - 1]
        if h & 1:
            full[h, :] = full[h - 1, :]
        s = full[0::2, 0::2] + full[0::2, 1::2] + full[1::2, 0::2] + full[1::2, 1::2]
        return ((s + (YUV_HALF << 2)) >> (YUV_FIX + 2)).astype(np.uint8)

    def pad(plane, ph, pw):
        out = np.empty((ph, pw), np.uint8)
        sh, sw = plane.shape
        out[:sh, :sw] = plane
        if sw < pw:
            out[:sh, sw:] = plane[:, sw - 1:sw]
        if sh < ph:
            out[sh:, :] = out[sh - 1:sh, :]
        return out

    return pad(y, mbh * 16, mbw * 16), pad(downsample(u_raw), mbh * 8, mbw * 8), \
        pad(downsample(v_raw), mbh * 8, mbw * 8)

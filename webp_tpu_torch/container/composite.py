"""Animation frame compositing onto the canvas, whole-frame numpy on the
host (a copy of the JAX package's `webp_tpu/container/composite.py`): the
integer src-over blend of non-premultiplied RGBA with a round-to-nearest
divide by 255, and the ANMF disposal and placement rules."""

from __future__ import annotations

from typing import Optional

import numpy as np


def div_by_255(v: np.ndarray) -> np.ndarray:
    """Round-to-nearest division by 255 on uint32 arrays."""
    return (((v + 0x80) >> 8) + v + 0x80) >> 8


def blend_nonpremult(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Src-over blend of non-premultiplied RGBA arrays [..., 4] uint8."""
    src32 = src.astype(np.uint32)
    dst32 = dst.astype(np.uint32)
    src_a = src32[..., 3]
    dst_a = dst32[..., 3]

    dst_factor_a = div_by_255(dst_a * (255 - src_a))
    blend_a = src_a + dst_factor_a
    # scale = 2^24 / blend_a, guarded against 0 (masked out below with src_a==0)
    safe_blend_a = np.maximum(blend_a, 1)
    scale = (1 << 24) // safe_blend_a

    out = np.empty_like(src)
    for c in range(3):
        unscaled = src32[..., c] * src_a + dst32[..., c] * dst_factor_a
        out[..., c] = ((unscaled * scale) >> 24).astype(np.uint8)
    out[..., 3] = blend_a.astype(np.uint8)

    transparent_src = src_a == 0
    out[transparent_src] = dst[transparent_src]
    return out


def composite_frame(
    canvas: np.ndarray,  # [H, W, 4] uint8, mutated in place
    clear_color: Optional[tuple],
    frame: np.ndarray,  # [fh, fw, 3|4] uint8
    fx: int,
    fy: int,
    frame_has_alpha: bool,
    use_alpha_blending: bool,
    prev_x: int,
    prev_y: int,
    prev_w: int,
    prev_h: int,
) -> None:
    ch, cw = canvas.shape[:2]
    fh, fw = frame.shape[:2]
    full = fx == 0 and fy == 0 and fw == cw and fh == ch

    if full and not use_alpha_blending:
        if frame_has_alpha:
            canvas[:, :] = frame
        else:
            canvas[:, :, :3] = frame
            canvas[:, :, 3] = 255
        return

    if clear_color is not None:
        col = np.array(clear_color, np.uint8)
        if full:
            canvas[:, :] = col
        else:
            canvas[prev_y : prev_y + prev_h, prev_x : prev_x + prev_w] = col

    w = min(fw, max(cw - fx, 0))
    h = min(fh, max(ch - fy, 0))
    if w == 0 or h == 0:
        return
    region = canvas[fy : fy + h, fx : fx + w]
    src = frame[:h, :w]

    if frame_has_alpha and use_alpha_blending:
        region[:, :] = blend_nonpremult(src, region)
    elif frame_has_alpha:
        region[:, :] = src
    else:
        region[:, :, :3] = src
        region[:, :, 3] = 255

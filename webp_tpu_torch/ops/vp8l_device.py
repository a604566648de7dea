"""Kernels K9-K12: the VP8L (lossless) inverse transforms, batched.

Replace `webp_tpu/ops/vp8l_device.py`: K9 `subtract_green` (:45), K10
`color_transform` (:51), K11 `color_indexing` (:74) and K12
`inverse_predictor_batch` (:159).  The CUDA kernels are `csrc/vp8l.cu`;
each `*_plain` function beside its wrapper is the kernel's torch twin.

Pixels are uint8 [B, h, w, 4] in R, G, B, A byte order, contiguous.  K9,
K10 and K12 work in place (the JAX functions return new arrays); K11
returns a new, wider tensor.  A wrapper takes its twin for CPU tensors and
launches its kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from .. import _build

_MODE_ZERO = 14  # predictor modes 14 and 15 (and any larger) add zero


def subsample(size: int, bits: int) -> int:
    """Blocks of 1 << bits covering `size` pixels."""
    return (size + (1 << bits) - 1) >> bits


def _pixels(px: torch.Tensor):
    """(B, h, w) of a contiguous uint8 pixel tensor [B, h, w, 4]."""
    if px.dtype != torch.uint8 or px.dim() != 4 or px.shape[3] != 4:
        raise ValueError(f"pixels must be uint8 [B, h, w, 4], got {px.dtype} {tuple(px.shape)}")
    if not px.is_contiguous() or px.data_ptr() % 4:
        raise ValueError("pixels must be contiguous and 4-byte aligned")
    return tuple(px.shape[:3])


def _words(t: torch.Tensor, shape) -> int:
    """Pointer of a contiguous uint8 tensor of `shape` that the kernels read
    as 32-bit words."""
    ptr = _build.dense(t, torch.uint8, shape)
    if ptr % 4:
        raise ValueError("tensor must be 4-byte aligned")
    return ptr


def _s8(t: torch.Tensor) -> torch.Tensor:
    """uint8 bytes read as int8, widened to int32."""
    return t.view(torch.int8).to(torch.int32)


# ---- K9 subtract-green -------------------------------------------------------


def subtract_green_plain_(px: torch.Tensor) -> torch.Tensor:
    g = px[..., 1]
    px[..., 0] += g
    px[..., 2] += g
    return px


def subtract_green_(px: torch.Tensor) -> torch.Tensor:
    """Add green back into red and blue (wrapping), in place."""
    B, h, w = _pixels(px)
    if px.device.type == "cpu":
        return subtract_green_plain_(px)
    _build.launch("subtract_green", "webp_vp8l_subtract_green", px.device, px.data_ptr(),
                  B * h * w)
    return px


# ---- K10 colour transform --------------------------------------------------


def color_transform_plain_(px: torch.Tensor, tf: torch.Tensor, size_bits: int) -> torch.Tensor:
    h, w = px.shape[1:3]
    by = torch.arange(h, device=px.device) >> size_bits
    bx = torch.arange(w, device=px.device) >> size_bits
    coef = _s8(tf[:, by][:, :, bx])                       # [B, h, w, 4]
    red_to_blue, green_to_blue, green_to_red = coef[..., 0], coef[..., 1], coef[..., 2]
    green = _s8(px[..., 1])
    red = (px[..., 0].to(torch.int32) + ((green_to_red * green) >> 5)) & 0xFF
    blue = px[..., 2].to(torch.int32) + ((green_to_blue * green) >> 5)
    blue = blue + ((red_to_blue * _s8(red.to(torch.uint8))) >> 5)
    px[..., 0] = red.to(torch.uint8)
    px[..., 2] = (blue & 0xFF).to(torch.uint8)
    return px


def color_transform_(px: torch.Tensor, tf: torch.Tensor, size_bits: int) -> torch.Tensor:
    """Inverse cross-colour transform, in place.  tf [B, bh, bw, 4] uint8:
    per block, byte 0 red_to_blue, 1 green_to_blue, 2 green_to_red (int8).
    Red takes (green_to_red * green) >> 5; blue then takes the green term
    and (red_to_blue * new red) >> 5."""
    B, h, w = _pixels(px)
    shape = (B, subsample(h, size_bits), subsample(w, size_bits), 4)
    dev = _build.same_device(px, tf)
    if dev.type == "cpu":
        if tuple(tf.shape) != shape:
            raise ValueError(f"colour transform image must be {shape}, got {tuple(tf.shape)}")
        return color_transform_plain_(px, tf, size_bits)
    _build.launch("color_transform", "webp_vp8l_color_transform", dev, px.data_ptr(),
                  _words(tf, shape), size_bits, w, h, B)
    return px


# ---- K11 colour indexing ---------------------------------------------------


def pack_bits(table_size: int) -> int:
    """log2 of the palette indices packed into one green byte."""
    return 3 if table_size <= 2 else 2 if table_size <= 4 else 1 if table_size <= 16 else 0


def color_indexing_plain(px: torch.Tensor, table: torch.Tensor, table_size: int,
                         final_width: int) -> torch.Tensor:
    B, h = px.shape[:2]
    idx = px[..., 1].to(torch.int64)                      # [B, h, pw]
    wb = pack_bits(table_size)
    if wb:
        x = torch.arange(final_width, device=px.device)
        bits = 8 >> wb
        shift = (x & ((1 << wb) - 1)) * bits
        idx = (idx[:, :, x >> wb] >> shift) & ((1 << bits) - 1)
    b = torch.arange(B, device=px.device)[:, None, None]
    return table[b, idx]


def color_indexing(px: torch.Tensor, table: torch.Tensor, table_size: int,
                   final_width: int) -> torch.Tensor:
    """Palette expansion: indices in green (packed 8, 4 or 2 to a byte for
    <= 2, <= 4, <= 16 entries), px [B, h, pw, 4] with pw =
    subsample(final_width, pack_bits(table_size)), table [B, 256, 4] uint8
    zero-padded past table_size -> new [B, h, final_width, 4]."""
    B, h, pw = _pixels(px)
    if not 1 <= table_size <= 256:
        raise ValueError(f"table_size {table_size} outside 1..256")
    if pw != subsample(final_width, pack_bits(table_size)):
        raise ValueError(f"packed width {pw} does not match width {final_width} at "
                         f"{table_size} entries")
    dev = _build.same_device(px, table)
    if dev.type == "cpu":
        if tuple(table.shape) != (B, 256, 4):
            raise ValueError(f"palette must be [{B}, 256, 4], got {tuple(table.shape)}")
        return color_indexing_plain(px, table, table_size, final_width)
    out = torch.empty((B, h, final_width, 4), dtype=torch.uint8, device=dev)
    _build.launch("color_indexing", "webp_vp8l_color_indexing", dev, px.data_ptr(), pw,
                  _words(table, (B, 256, 4)), table_size, final_width, h, B,
                  out.data_ptr())
    return out


# ---- K12 inverse predictor ---------------------------------------------------


def _avg2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a + b) >> 1


def predict(mode: torch.Tensor, L, T, TL, TR) -> torch.Tensor:
    """The predictors of VP8L, selected per pixel.  Neighbours int32 [..., 4],
    mode int64 [...]; modes >= 14 predict zero.  Returns int32 [..., 4]."""
    zero = torch.zeros_like(L)
    black = zero.clone()
    black[..., 3] = 255
    p = L + T - TL
    left_closer = ((p - L).abs().sum(-1, keepdim=True) < (p - T).abs().sum(-1, keepdim=True))
    a = (L + T) >> 1
    d = a - TL
    half = torch.where(d >= 0, d >> 1, -((-d) >> 1))      # (a - TL) / 2, toward zero
    preds = torch.stack([
        black, L, T, TR, TL,                              # 0-4
        _avg2(_avg2(L, TR), T), _avg2(L, TL), _avg2(L, T), _avg2(TL, T), _avg2(T, TR),  # 5-9
        _avg2(_avg2(L, TL), _avg2(T, TR)),                # 10
        torch.where(left_closer, L, T),                   # 11
        p.clamp(0, 255),                                  # 12
        (a + half).clamp(0, 255),                         # 13
        zero,                                             # 14, 15, ...
    ])
    sel = mode.clamp(max=_MODE_ZERO)[None, ..., None].expand(1, *L.shape)
    return preds.gather(0, sel)[0]


def inverse_predictor_plain_(px: torch.Tensor, modes: torch.Tensor, size_bits: int) -> torch.Tensor:
    """A wavefront over t = x + 2y: every pixel of a step has its left,
    top-left, top and top-right neighbours final from earlier steps."""
    B, h, w = px.shape[:3]
    mode_map = modes.to(torch.int64)
    b = torch.arange(B, device=px.device)[:, None]
    for t in range(w + 2 * (h - 1)):
        y = torch.arange(max(0, (t - w + 2) // 2), min(h - 1, t // 2) + 1, device=px.device)
        x = t - 2 * y
        yu, xl, xr = (y - 1).clamp(min=0), (x - 1).clamp(min=0), (x + 1).clamp(max=w - 1)
        nb = px[:, torch.stack([y, yu, yu, yu, y]), torch.stack([xl, x, xl, xr, torch.zeros_like(x)])]
        L, T, TL, TR, first = nb.to(torch.int32).unbind(1)
        TR = torch.where((x == w - 1)[None, :, None], first, TR)  # the last column wraps
        mode = mode_map[:, y >> size_bits, x >> size_bits]
        mode = torch.where((y == 0)[None], 1, torch.where((x == 0)[None], 2, mode))
        mode = torch.where(((y == 0) & (x == 0))[None], 0, mode)
        res = px[b, y[None], x[None]].to(torch.int32)
        px[b, y[None], x[None]] = ((res + predict(mode, L, T, TL, TR)) & 0xFF).to(torch.uint8)
    return px


def inverse_predictor_(px: torch.Tensor, modes: torch.Tensor, size_bits: int) -> torch.Tensor:
    """Inverse predictor transform, in place: px holds the residuals, modes
    [B, bh, bw] uint8 the predictor image's green channel (2 <= size_bits
    <= 9).  Pixel (0, 0) adds opaque black, the rest of row 0 its left
    neighbour, the rest of column 0 its top; the last column's top-right is
    the first pixel of its own row."""
    B, h, w = _pixels(px)
    if not 2 <= size_bits <= 9:
        raise ValueError(f"size_bits {size_bits} outside 2..9")
    shape = (B, subsample(h, size_bits), subsample(w, size_bits))
    dev = _build.same_device(px, modes)
    if dev.type == "cpu":
        if tuple(modes.shape) != shape:
            raise ValueError(f"predictor modes must be {shape}, got {tuple(modes.shape)}")
        return inverse_predictor_plain_(px, modes, size_bits)
    _build.launch("predictor", "webp_vp8l_predictor", dev, px.data_ptr(),
                  _build.dense(modes, torch.uint8, shape), size_bits, w, h, B)
    return px

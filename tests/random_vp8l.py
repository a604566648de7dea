"""Seeded VP8L (lossless) streams, written without an encoder.

`vp8l_stream(rgba, seed, transforms)` writes a stream that decodes to
exactly the RGBA image `rgba` [h, w, 4] uint8, through the transforms given
in stream order, each of which it applies forward:

- `SUBTRACT_GREEN`: red and blue minus green;
- `predictor(size_bits)`: seeded modes 0-13 per block, residuals against
  the image's own neighbours under the decoder's edge rules (pixel (0, 0)
  against opaque black, row 0 against its left, column 0 against its top,
  the last column's top-right being the row's first pixel);
- `color(size_bits)`: seeded int8 coefficients per block; blue's red term
  is taken from the original red, as the decoder takes it from the
  decoded one;
- `PALETTE`: the image's colours (at most 256) in a seeded order,
  delta-coded as the decoder undoes it, the indices packed 8, 4 or 2 to a
  byte for <= 2, <= 4, <= 16 colours.  A transform after it sees the packed
  image.

Any order of the four is allowed, each at most once.  The entropy code is
literals only, under complete canonical codes: lengths 8 for the 256-symbol
alphabets, 232 x 8 + 48 x 9 for the 280-symbol green alphabet, a
one-symbol simple code for distances; no colour cache, no meta prefix
codes, no backward references.  `implicit=True` leaves out the header, as
an ALPH payload does.

The module imports neither jax nor the JAX package, so `chip_smoke.py` can
use it where only PyTorch is installed; `tests/test_torch_vp8l.py` holds
its streams' decode by the port, by the C++ decoder and by the JAX
package's scalar and device decoders to the source images.
"""

from __future__ import annotations

import numpy as np

SUBTRACT_GREEN = ("subtract_green",)
PALETTE = ("palette",)
_TYPES = {"predictor": 0, "color": 1, "subtract_green": 2, "palette": 3}

# Order in which the code-length code's lengths are sent.
_CL_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)


def predictor(size_bits: int) -> tuple:
    return ("predictor", size_bits)


def color(size_bits: int) -> tuple:
    return ("color", size_bits)


def _subsample(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


class _BitWriter:
    """LSB-first bit stream of (value, width) fields."""

    def __init__(self):
        self.values, self.widths = [], []

    def put(self, value: int, nbits: int) -> None:
        self.put_many(np.array([value]), np.array([nbits]))

    def put_many(self, values, widths) -> None:
        self.values.append(np.asarray(values, np.uint64).reshape(-1))
        self.widths.append(np.broadcast_to(np.asarray(widths, np.int64), np.shape(values))
                           .reshape(-1))

    def to_bytes(self) -> bytes:
        v, n = np.concatenate(self.values), np.concatenate(self.widths)
        pos = np.cumsum(n) - n
        bits = np.zeros(int(n.sum()), np.uint8)
        for k in range(int(n.max())):
            sel = n > k
            bits[pos[sel] + k] = (v[sel] >> np.uint64(k)) & np.uint64(1)
        return np.packbits(bits, bitorder="little").tobytes()


def _codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical prefix codes of `lengths`, bit-reversed for the LSB-first
    stream (a code is sent from its most significant bit)."""
    codes = np.zeros(len(lengths), np.int64)
    nxt = 0
    for length in range(1, int(lengths.max()) + 1):
        syms = np.flatnonzero(lengths == length)
        codes[syms] = nxt + np.arange(len(syms))
        nxt = (nxt + len(syms)) << 1
    rev = np.zeros_like(codes)
    for b in range(int(lengths.max())):
        rev |= np.where(b < lengths, ((codes >> b) & 1) << np.maximum(lengths - 1 - b, 0), 0)
    return rev


_LEN_BYTE = np.full(256, 8, np.int64)
_LEN_GREEN = np.array([8] * 232 + [9] * 48, np.int64)  # 256 literals + 24 length codes
_CODE_BYTE, _CODE_GREEN = _codes(_LEN_BYTE), _codes(_LEN_GREEN)


def _write_lengths_code(bw: _BitWriter, lengths: np.ndarray) -> None:
    """A normal prefix code of lengths 8 and 9, its lengths sent under a
    two-symbol code-length code (8 -> '0', 9 -> '1')."""
    bw.put(0, 1)                                  # not a simple code
    n_cl = _CL_ORDER.index(9) + 1
    bw.put(n_cl - 4, 4)
    bw.put_many([1 if s in (8, 9) else 0 for s in _CL_ORDER[:n_cl]], 3)
    bw.put(0, 1)                                  # max_symbol = the alphabet
    bw.put_many((lengths == 9).astype(np.int64), 1)


def _write_image(bw: _BitWriter, px: np.ndarray, is_argb: bool) -> None:
    """An entropy-coded image [h, w, 4] of literals."""
    bw.put(0, 1)                                  # no colour cache
    if is_argb:
        bw.put(0, 1)                              # no meta prefix codes
    _write_lengths_code(bw, _LEN_GREEN)
    for _ in range(3):                            # red, blue, alpha
        _write_lengths_code(bw, _LEN_BYTE)
    bw.put_many([1, 0, 0, 0], 1)                  # distance: simple code, one symbol, 0
    flat = px.reshape(-1, 4).astype(np.int64)
    g, r, b, a = flat[:, 1], flat[:, 0], flat[:, 2], flat[:, 3]
    values = np.stack([_CODE_GREEN[g], _CODE_BYTE[r], _CODE_BYTE[b], _CODE_BYTE[a]], 1)
    widths = np.stack([_LEN_GREEN[g], _LEN_BYTE[r], _LEN_BYTE[b], _LEN_BYTE[a]], 1)
    bw.put_many(values, widths)


def _s8(a: np.ndarray) -> np.ndarray:
    return a.astype(np.uint8).view(np.int8).astype(np.int32)


def _predictions(mode: int, L, T, TL, TR):
    """Prediction of one mode (0-13) from int32 neighbour arrays [..., 4]."""
    avg = lambda a, b: (a + b) >> 1  # noqa: E731
    if mode == 0:
        out = np.zeros_like(L)
        out[..., 3] = 255
        return out
    if mode == 11:
        p = L + T - TL
        left = np.abs(p - L).sum(-1, keepdims=True) < np.abs(p - T).sum(-1, keepdims=True)
        return np.where(left, L, T)
    if mode == 12:
        return np.clip(L + T - TL, 0, 255)
    if mode == 13:
        a = avg(L, T)
        d = a - TL
        return np.clip(a + np.where(d >= 0, d >> 1, -((-d) >> 1)), 0, 255)
    return {1: L, 2: T, 3: TR, 4: TL, 5: avg(avg(L, TR), T), 6: avg(L, TL), 7: avg(L, T),
            8: avg(TL, T), 9: avg(T, TR), 10: avg(avg(L, TL), avg(T, TR))}[mode]


def _forward_predictor(img: np.ndarray, modes: np.ndarray, size_bits: int) -> np.ndarray:
    h, w = img.shape[:2]
    c = img.astype(np.int32)
    L, T, TL, TR = (np.zeros_like(c) for _ in range(4))
    L[:, 1:] = c[:, :-1]
    T[1:] = c[:-1]
    TL[1:, 1:] = c[:-1, :-1]
    TR[1:, :-1] = c[:-1, 1:]
    TR[:, -1] = c[:, 0]                           # the last column wraps to the row's start
    mode = modes[np.arange(h)[:, None] >> size_bits, np.arange(w)[None, :] >> size_bits]
    mode = mode.astype(np.int64)
    mode[0, :] = 1
    mode[:, 0] = 2
    mode[0, 0] = 0
    pred = np.zeros_like(c)
    for m in np.unique(mode):
        pred = np.where((mode == m)[..., None], _predictions(int(m), L, T, TL, TR), pred)
    return ((c - pred) & 0xFF).astype(np.uint8)


def _forward_color(img: np.ndarray, coef: np.ndarray, size_bits: int) -> np.ndarray:
    h, w = img.shape[:2]
    cf = coef[np.arange(h)[:, None] >> size_bits, np.arange(w)[None, :] >> size_bits]
    red_to_blue, green_to_blue, green_to_red = _s8(cf[..., 0]), _s8(cf[..., 1]), _s8(cf[..., 2])
    out = img.copy()
    green, red = _s8(img[..., 1]), img[..., 0].astype(np.int32)
    out[..., 0] = (red - ((green_to_red * green) >> 5)) & 0xFF
    out[..., 2] = (img[..., 2].astype(np.int32) - ((green_to_blue * green) >> 5)
                   - ((red_to_blue * _s8(img[..., 0])) >> 5)) & 0xFF
    return out


def _forward_palette(img: np.ndarray, rng):
    """(packed index image, palette [n, 4]) of an image of <= 256 colours."""
    h, w = img.shape[:2]
    words = np.ascontiguousarray(img).view(np.uint32)[..., 0]
    colours, inverse = np.unique(words, return_inverse=True)
    if len(colours) > 256:
        raise ValueError(f"a palette holds 256 colours, the image has {len(colours)}")
    order = rng.permutation(len(colours))         # palette position -> colour
    position = np.argsort(order)
    idx = position[inverse.reshape(h, w)]
    n = len(colours)
    wbits = 3 if n <= 2 else 2 if n <= 4 else 1 if n <= 16 else 0
    per, bits = 1 << wbits, 8 >> wbits
    pw = _subsample(w, wbits)
    padded = np.zeros((h, pw * per), np.int64)
    padded[:, :w] = idx
    packed = np.zeros((h, pw), np.int64)
    for k in range(per):
        packed |= padded[:, k::per] << (k * bits)
    out = np.zeros((h, pw, 4), np.uint8)
    out[..., 1] = packed
    out[..., 3] = 255
    table = colours[order].astype(np.uint32).view(np.uint8).reshape(n, 4)
    return out, table


def vp8l_stream(rgba: np.ndarray, seed: int, transforms=(), implicit: bool = False) -> bytes:
    """A VP8L stream of `rgba` [h, w, 4] uint8 through `transforms` (stream
    order); the predictor modes, colour coefficients, palette order and the
    sub-images' unused channels come from `seed`."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w = rgba.shape[:2]
    if rgba.shape[2:] != (4,) or not (1 <= w <= 16384 and 1 <= h <= 16384):
        raise ValueError(f"need RGBA [h, w, 4] of 1..16384 pixels a side, got {rgba.shape}")
    kinds = [t[0] for t in transforms]
    if len(set(kinds)) != len(kinds) or not set(kinds) <= set(_TYPES):
        raise ValueError(f"transforms must be distinct and known: {transforms}")
    rng = np.random.RandomState(seed)
    bw = _BitWriter()
    if not implicit:
        bw.put(0x2F, 8)
        bw.put(w - 1, 14)
        bw.put(h - 1, 14)
        bw.put(int((rgba[..., 3] != 255).any()), 1)
        bw.put(0, 3)
    img = rgba
    for t in transforms:
        bw.put(1, 1)
        bw.put(_TYPES[t[0]], 2)
        if t[0] in ("predictor", "color"):
            size_bits = t[1]
            bh, bwid = _subsample(h, size_bits), _subsample(img.shape[1], size_bits)
            sub = rng.randint(0, 256, (bh, bwid, 4)).astype(np.uint8)
            bw.put(size_bits - 2, 3)
            if t[0] == "predictor":
                sub[..., 1] = rng.randint(0, 14, (bh, bwid))
                img = _forward_predictor(img, sub[..., 1], size_bits)
            else:
                img = _forward_color(img, sub, size_bits)
            _write_image(bw, sub, False)
        elif t[0] == "subtract_green":
            img = img.copy()
            img[..., 0] -= img[..., 1]
            img[..., 2] -= img[..., 1]
        else:
            img, table = _forward_palette(img, rng)
            bw.put(len(table) - 1, 8)
            delta = table.copy()
            delta[1:] -= table[:-1]                # wraps: uint8
            _write_image(bw, delta[None], False)
    bw.put(0, 1)
    _write_image(bw, img, True)
    return bw.to_bytes()


def with_alpha(rgb: np.ndarray, seed: int) -> np.ndarray:
    """RGBA of an RGB frame: opaque, but for seeded rectangles of other
    alpha values."""
    rng = np.random.RandomState(seed)
    h, w = rgb.shape[:2]
    alpha = np.full((h, w), 255, np.uint8)
    for _ in range(4):
        y0, x0 = rng.randint(0, h), rng.randint(0, w)
        alpha[y0: y0 + rng.randint(1, h // 2 + 2), x0: x0 + rng.randint(1, w // 2 + 2)] = \
            rng.randint(0, 256)
    return np.dstack([rgb, alpha])


def quantize(rgba: np.ndarray, n_colours: int, seed: int) -> np.ndarray:
    """The image in at most `n_colours` seeded RGBA colours, one for each
    of as many luma quantiles."""
    rng = np.random.RandomState(seed)
    colours = rng.randint(0, 256, (n_colours, 4)).astype(np.uint8)
    luma = rgba[..., :3].astype(np.int64) @ np.array([77, 150, 29])
    edges = np.quantile(luma, np.arange(1, n_colours) / n_colours)
    return colours[np.searchsorted(edges, luma, side="right")]

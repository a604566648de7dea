"""VP8L (lossless WebP) encoder, on the host.

The port of `webp_tpu/encode/vp8l.py`: subtract-green; a per-tile
best-of-14 predictor transform; a per-tile cross-colour transform;
windowed LZ77 (the C++ hash-chain matcher) with the spec's distance plane
codes; an entropy-gated colour cache; meta-Huffman entropy groups;
rep-coded tree serialisation; a colour-indexing (palette) route for
images of at most 256 colours; near-lossless pre-quantisation; and the
ALPH payload.  Transforms, histograms and the bit packing are numpy; the
LZ77 search, the limited Huffman code lengths, the colour-cache hits and
the predictor choice are the C++ of `native/vp8l.cpp` (`io/native.py`).
No device kernel runs here, as in the JAX package.

The float64 least squares and entropy estimates run in the JAX package's
order, and ties break the same way, so the streams are byte-equal to its
native route.
"""

from __future__ import annotations

import numpy as np

from ..errors import InvalidDimensions
from ..io import native

# The VP8L spec's 2-D short-distance map: distance codes 1..120 address a
# neighbourhood of the current pixel as (x offset, y offset).
DISTANCE_MAP = (
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2),
    (2, 1), (-2, 1), (2, 2), (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3),
    (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2), (0, 4), (4, 0),
    (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4),
    (4, 2), (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0),
    (1, 5), (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2),
    (4, 4), (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0),
    (1, 6), (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2), (-6, 2),
    (4, 5), (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3),
    (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5), (7, 1), (-7, 1),
    (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2),
    (3, 7), (-3, 7), (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5),
    (8, 0), (4, 7), (-4, 7), (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6),
    (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5), (8, 4), (6, 7),
    (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7),
)


# -- canonical, length-limited Huffman --------------------------------------

def build_code_lengths(freqs: np.ndarray, limit: int) -> np.ndarray:
    """Huffman code lengths (<= limit) for symbol frequencies, from the C++;
    all-zero when fewer than two symbols are used."""
    n = len(freqs)
    used = np.flatnonzero(freqs)
    if len(used) <= 1:
        return np.zeros(n, np.int64)
    if len(used) > (1 << limit):
        # No prefix code of depth <= limit exists; the codec never requests
        # this (limit 7 only for the 19-symbol code-length alphabet, limit 15
        # for alphabets <= 2328) — fail loudly instead of emitting garbage.
        raise ValueError(f"{len(used)} symbols cannot fit depth-{limit} code")
    out = native.vp8l_huffman_lengths(np.asarray(freqs, np.int64)[None], np.array([0, n]), limit)
    return out[0].astype(np.int64)


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Assign canonical codes (bit-reversed for LSB-first writing)."""
    codes = np.zeros(len(lengths), np.int64)
    code = 0
    max_len = int(lengths.max()) if len(lengths) else 0
    for ln in range(1, max_len + 1):
        for i in np.flatnonzero(lengths == ln):
            rev = int(f"{code:0{ln}b}"[::-1], 2)
            codes[i] = rev
            code += 1
        code <<= 1
    return codes


# -- LSB-first vectorized bit stream ----------------------------------------

class BitStream:
    """Accumulates (code, nbits) entries; packs once with a scatter-add."""

    def __init__(self):
        self.chunks = []  # list of (codes int64 array, nbits int64 array)

    def append(self, codes, nbits):
        self.chunks.append(
            (np.asarray(codes, np.int64).reshape(-1), np.asarray(nbits, np.int64).reshape(-1))
        )

    def append_bits(self, value: int, nbits: int):
        self.append([value], [nbits])

    def to_bytes(self) -> bytes:
        codes = np.concatenate([c for c, _ in self.chunks]) if self.chunks else np.zeros(0, np.int64)
        nbits = np.concatenate([n for _, n in self.chunks]) if self.chunks else np.zeros(0, np.int64)
        keep = nbits > 0
        codes, nbits = codes[keep], nbits[keep]
        offsets = np.zeros(len(nbits) + 1, np.int64)
        np.cumsum(nbits, out=offsets[1:])
        total_bits = int(offsets[-1])
        nbytes = (total_bits + 7) // 8
        acc = np.zeros(nbytes + 8, np.int64)
        byte_idx = offsets[:-1] >> 3
        shift = offsets[:-1] & 7
        # Codes are < 2^25 (15-bit code + 7-bit shift fits in 32 bits).
        val = codes << shift
        for b in range(4):
            np.add.at(acc, byte_idx + b, (val >> (8 * b)) & 0xFF)
        return acc[:nbytes].astype(np.uint8).tobytes()


# -- tree serialization ------------------------------------------------------

_CL_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)


def _write_single_entry_tree(bs: BitStream, symbol: int):
    bs.append_bits(1, 2)  # simple tree, one symbol
    if symbol <= 1:
        bs.append_bits(0, 1)
        bs.append_bits(symbol, 1)
    else:
        bs.append_bits(1, 1)
        bs.append_bits(symbol, 8)


def write_huffman_tree(bs: BitStream, freqs: np.ndarray):
    """Serialize a tree; returns (lengths, codes) for the symbol writer.

    Single-symbol alphabets use the simple-tree form when the symbol fits
    8 bits, else a code-length-coded tree with one nonzero entry (the
    decoder's from_single path — symbols then cost zero bits either way)."""
    lengths = build_code_lengths(freqs, 15)
    if lengths.max() == 0:
        used = np.flatnonzero(freqs)
        sym = int(used[0]) if len(used) else 0
        if sym <= 255:
            _write_single_entry_tree(bs, sym)
        else:
            ser = np.zeros(len(freqs), np.int64)
            ser[sym] = 1
            _write_cl_coded(bs, ser)
        return lengths, np.zeros(len(freqs), np.int64)
    codes = canonical_codes(lengths)
    _write_cl_coded(bs, lengths)
    return lengths, codes


def _cl_sequence(lengths: np.ndarray):
    """Code-length RLE: (symbols, extra_vals, extra_bits) using rep codes
    16 (repeat previous nonzero length 3-6), 17 (3-10 zeros), 18 (11-138
    zeros) — decoder semantics in decode/vp8l.py _read_code_lengths."""
    n = len(lengths)
    if n and (lengths == lengths[0]).all() and lengths[0] != 0:
        # uniform lengths: a single-symbol code-length code costs 0 bits/sym
        v = int(lengths[0])
        return [v] * n, [0] * n, [0] * n
    sym, ev, eb = [], [], []
    prev = 8
    i = 0
    while i < n:
        v = int(lengths[i])
        j = i
        while j < n and lengths[j] == v:
            j += 1
        run = j - i
        if v == 0:
            while run >= 11:
                take = min(run, 138)
                sym.append(18); ev.append(take - 11); eb.append(7)
                run -= take
            while run >= 3:
                take = min(run, 10)
                sym.append(17); ev.append(take - 3); eb.append(3)
                run -= take
            for _ in range(run):
                sym.append(0); ev.append(0); eb.append(0)
        else:
            r = run
            if v != prev:
                sym.append(v); ev.append(0); eb.append(0)
                r -= 1
                prev = v
            while r >= 3:
                take = min(r, 6)
                sym.append(16); ev.append(take - 3); eb.append(2)
                r -= take
            for _ in range(r):
                sym.append(v); ev.append(0); eb.append(0)
        i = j
    return sym, ev, eb


def _write_cl_coded(bs: BitStream, lengths: np.ndarray):
    """Write the code-length-coded tree form for a full `lengths` array."""
    seq_sym, seq_ev, seq_eb = _cl_sequence(lengths)
    seq_sym = np.asarray(seq_sym, np.int64)
    seq_ev = np.asarray(seq_ev, np.int64)
    seq_eb = np.asarray(seq_eb, np.int64)

    cl_freqs = np.bincount(seq_sym, minlength=19)[:19]
    cl_lengths = build_code_lengths(cl_freqs, 7)
    single_cl = cl_lengths.max() == 0
    cl_codes = canonical_codes(cl_lengths)

    bs.append_bits(0, 1)  # normal (code-length-coded) tree
    bs.append_bits(19 - 4, 4)
    for i in _CL_ORDER:
        if cl_freqs[i] == 0:
            bs.append_bits(0, 3)
        elif single_cl:
            bs.append_bits(1, 3)
        else:
            bs.append_bits(int(cl_lengths[i]), 3)
    bs.append_bits(0, 1)  # no explicit max_symbol
    # Interleave cl codes with rep-code extra bits (cl codes are 0-wide in
    # the single-symbol case but the extras still ride the stream).
    m = len(seq_sym)
    codes2 = np.empty(2 * m, np.int64)
    bits2 = np.empty(2 * m, np.int64)
    codes2[0::2] = cl_codes[seq_sym]
    bits2[0::2] = cl_lengths[seq_sym]
    codes2[1::2] = seq_ev
    bits2[1::2] = seq_eb
    bs.append(codes2, bits2)


def _length_to_symbol(run: np.ndarray):
    """Run length -> (prefix symbol, extra_bits count) vectorized."""
    lm1 = run - 1
    high = np.int64(np.floor(np.log2(np.maximum(lm1, 1))))
    second = (lm1 >> np.maximum(high - 1, 0)) & 1
    symbol = 2 * high + second
    extra = np.maximum(high - 1, 0)
    return symbol, extra


# -- main entry --------------------------------------------------------------

def _cache_hits(packed: np.ndarray, bits: int):
    """Exact color-cache hit mask, from the C++: pixel i hits iff the most
    recent earlier pixel in its hash bucket holds the same value (every
    decoded pixel is inserted, so the bucket's last writer before i
    decides)."""
    return native.vp8l_cache_hits(packed.astype(np.uint32), bits)


def _entropy_bits(freq: np.ndarray) -> float:
    tot = freq.sum()
    if tot == 0:
        return 0.0
    p = freq[freq > 0] / tot
    return float(-(p * np.log2(p)).sum() * tot)


def encode_lossless(
    rgba: np.ndarray,
    use_predictor: bool = True,
    implicit_dims: bool = False,
    alpha_used: bool = True,
    cache_bits: int = 10,
    predictor_size_bits: int = None,
) -> bytes:
    """Encode an [h, w, 4] RGBA array as a VP8L stream.

    Pipeline: subtract-green, per-block best-of-14 predictor transform
    (4-px tiles by default), per-block cross-color, windowed LZ77 +
    entropy-gated color cache, meta-Huffman groups, canonical Huffman coding.
    """
    h, w = rgba.shape[:2]
    if not (0 < w <= 16384 and 0 < h <= 16384):
        raise InvalidDimensions(f"{w}x{h}")

    # Palette path: when the image has <= 256 distinct colors, encode a
    # color-indexing transform variant too and keep whichever is smaller.
    flat = np.ascontiguousarray(rgba.reshape(-1, 4)).view(np.uint32)[:, 0]
    colors = np.unique(flat)
    pal_bytes = None
    if len(colors) <= 256:
        pal_bytes = _encode_palette(
            rgba, colors, implicit_dims, alpha_used, cache_bits
        )

    bs = BitStream()
    if not implicit_dims:
        bs.append_bits(0x2F, 8)
        bs.append_bits(w - 1, 14)
        bs.append_bits(h - 1, 14)
        bs.append_bits(1 if alpha_used else 0, 1)
        bs.append_bits(0, 3)

    px = rgba.reshape(-1, 4).astype(np.int16).copy()
    # Subtract green.
    bs.append_bits(0b101, 3)
    px[:, 0] -= px[:, 1]
    px[:, 2] -= px[:, 1]

    if use_predictor:
        sb, modes, out = _pick_predictors(
            (px.reshape(h, w, 4) & 0xFF), w, h, predictor_size_bits
        )
        # transform header: present(1) | type(00=predictor) | size_bits-2
        bs.append_bits(1 | ((sb - 2) << 3), 6)
        bh, bw = modes.shape
        mode_px = np.zeros((bh * bw, 4), np.int64)
        mode_px[:, 1] = modes.reshape(-1)
        _write_image_stream(bs, mode_px, bw, cache_bits=0, is_argb=False)
        px = out.reshape(-1, 4)

        # Cross-color transform on the predictor residuals (per-block
        # least-squares slopes, entropy-gated). Stream order SG, PRED, CT
        # decodes as CT^-1, PRED^-1, SG^-1.
        coefs, ct_out, gain = _pick_color_transform(
            (px.reshape(h, w, 4) & 0xFF), w, h, sb
        )
        if gain > 12.0 * coefs.shape[0] * coefs.shape[1]:  # > sub-image cost
            bs.append_bits(1 | (1 << 1) | ((sb - 2) << 3), 6)
            cbh, cbw = coefs.shape[:2]
            _write_image_stream(
                bs, coefs.reshape(-1, 4).astype(np.int64), cbw,
                cache_bits=0, is_argb=False,
            )
            px = ct_out.reshape(-1, 4)

    px = (px & 0xFF).astype(np.int64)
    bs.append_bits(0, 1)  # transforms done
    _write_image_stream(bs, px, w, cache_bits=cache_bits, is_argb=True)
    out = bs.to_bytes()
    if pal_bytes is not None and len(pal_bytes) < len(out):
        return pal_bytes
    return out


def _encode_palette(rgba: np.ndarray, colors: np.ndarray, implicit_dims: bool,
                    alpha_used: bool, cache_bits: int) -> bytes:
    """Color-indexing (palette) encoding: delta-coded palette sub-image +
    an index image in the green channel, sub-byte packed for <= 16 colors
    (decoder: ops/vp8l_transforms.py inverse_color_indexing)."""
    h, w = rgba.shape[:2]
    n_colors = len(colors)
    bs = BitStream()
    if not implicit_dims:
        bs.append_bits(0x2F, 8)
        bs.append_bits(w - 1, 14)
        bs.append_bits(h - 1, 14)
        bs.append_bits(1 if alpha_used else 0, 1)
        bs.append_bits(0, 3)

    # transform header: present(1) | type(11=color indexing) | size-1
    bs.append_bits(1 | (3 << 1), 3)
    bs.append_bits(n_colors - 1, 8)
    # Palette entries delta-coded per channel; stored as an image stream.
    pal = colors.view(np.uint8).reshape(n_colors, 4)  # r,g,b,a byte order
    delta = pal.astype(np.int64)
    delta[1:] = (pal[1:].astype(np.int64) - pal[:-1].astype(np.int64)) & 0xFF
    _write_image_stream(bs, delta, n_colors, cache_bits=0, is_argb=False)

    # Index image (possibly sub-byte packed).
    flat = np.ascontiguousarray(rgba.reshape(-1, 4)).view(np.uint32)[:, 0]
    idx = np.searchsorted(colors, flat).reshape(h, w)
    if n_colors <= 2:
        w_bits = 3
    elif n_colors <= 4:
        w_bits = 2
    elif n_colors <= 16:
        w_bits = 1
    else:
        w_bits = 0
    if w_bits:
        per = 1 << w_bits
        bpp = 8 >> w_bits
        pw = (w + per - 1) // per
        padded = np.zeros((h, pw * per), np.int64)
        padded[:, :w] = idx
        shifts = (np.arange(per) * bpp)[None, None, :]
        packed = (padded.reshape(h, pw, per) << shifts).sum(-1)
    else:
        pw = w
        packed = idx
    px = np.zeros((h * pw, 4), np.int64)
    px[:, 1] = packed.reshape(-1)

    bs.append_bits(0, 1)  # transforms done
    _write_image_stream(bs, px, pw, cache_bits=cache_bits, is_argb=True)
    return bs.to_bytes()


def _s8(v):
    return ((v.astype(np.int32) + 128) & 0xFF) - 128


def _pick_color_transform(u: np.ndarray, w: int, h: int, size_bits: int):
    """Per-block cross-color coefficients (green->red, green->blue,
    red->blue) by least squares on int8-interpreted residuals, each kept
    only when it beats coefficient 0 on the entropy surrogate.

    Returns (coefs [bh, bw, 4] uint8 sub-image pixels with red_to_blue in
    byte 0 / green_to_blue in byte 1 / green_to_red in byte 2, transformed
    [h, w, 4] int64, estimated bit gain)."""
    S = 1 << size_bits
    bw = _subsample_enc(w, size_bits)
    bh = _subsample_enc(h, size_bits)

    def pool(x):  # [h, w] -> [bh, bw] block sums
        p = np.zeros((bh * S, bw * S), x.dtype)
        p[:h, :w] = x
        return p.reshape(bh, S, bw, S).sum((1, 3))

    def ls_coef(xs, ys):
        num = pool((xs * ys).astype(np.int64))
        den = pool((xs * xs).astype(np.int64))
        c = np.round(32.0 * num / np.maximum(den, 1)).astype(np.int64)
        return np.clip(c, -128, 127)

    def cost(res_bytes):  # [h, w] wrapped residual bytes -> [bh, bw] bits
        wrapped = np.minimum(res_bytes, 256 - res_bytes)
        return pool(_PRED_COST_LUT[wrapped])

    def expand(cblk):  # [bh, bw] -> per-pixel [h, w]
        return cblk[np.arange(h) >> size_bits][:, np.arange(w) >> size_bits]

    gs = _s8(u[:, :, 1])

    def apply(chan, xs, name_cost0):
        """Pick per-block coef for `chan -= (coef*xs)>>5`; returns
        (coef [bh,bw], new channel bytes, gain)."""
        c_fit = ls_coef(xs, _s8(chan))
        fitpx = expand(c_fit)
        newb = (chan - ((fitpx * xs) >> 5)) & 0xFF
        c0 = name_cost0
        cf = cost(newb)
        use_fit = cf + 0.5 < c0  # slight bias toward 0 (cheaper sub-image)
        coef = np.where(use_fit, c_fit, 0)
        out = np.where(expand(use_fit), newb, chan)
        return coef, out, float(np.where(use_fit, c0 - cf, 0.0).sum())

    r = u[:, :, 0].astype(np.int32)
    b = u[:, :, 2].astype(np.int32)

    g2r, r2, g1 = apply(r, gs, cost(r))
    g2b, b2, g2 = apply(b, gs, cost(b))
    # The decoder's red_to_blue term uses the red value it has already
    # inverse-transformed, i.e. the ORIGINAL (pre-CT) red on our side.
    r2b, b3, g3 = apply(b2, _s8(u[:, :, 0]), cost(b2))
    gain = g1 + g2 + g3

    coefs = np.zeros((bh, bw, 4), np.uint8)
    coefs[:, :, 0] = r2b & 0xFF
    coefs[:, :, 1] = g2b & 0xFF
    coefs[:, :, 2] = g2r & 0xFF
    out = u.astype(np.int64).copy()
    out[:, :, 0] = r2
    out[:, :, 2] = b3
    return coefs, out, gain


_PRED_COST_LUT = np.log2(1.0 + np.arange(129))
# fixed-point (1/32 bit) variant for the int16 predictor-cost hot path
_PRED_COST_LUT32 = np.round(_PRED_COST_LUT * 32.0).astype(np.uint8)


def _pick_predictors(u: np.ndarray, w: int, h: int, size_bits=None):
    """Choose the best of the 14 VP8L predictors per block, in the C++.

    u: [h, w, 4] int (0..255) pixels in the subtract-green domain. Cost
    proxy: sum of log2(1+|wrapped residual|) over channels — a per-pixel
    entropy surrogate; forced-mode edge pixels (row 0 = L, column 0 = T)
    are excluded. Returns (size_bits, modes [bh, bw] uint8,
    residual [h, w, 4] int64).  `size_bits` None takes 4-px tiles, which
    win consistently on real content.
    """
    if size_bits is None:
        size_bits = 2
    modes, res = native.vp8l_pick_predictors(u.astype(np.uint8), w, h, size_bits,
                                             _PRED_COST_LUT32)
    return size_bits, modes, res.astype(np.int64)


def _subsample_enc(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _write_image_stream(bs: BitStream, px: np.ndarray, width: int,
                        cache_bits: int, is_argb: bool):
    """Write one VP8L-coded image stream (cache flag, [meta flag for ARGB],
    5 trees, token stream) for px [n, 4] int64 (r, g, b, a) values 0..255.

    `width` feeds the distance->plane-code mapping (the 2D neighborhood
    codes are width-relative); token distances are linear either way.
    """
    w = width
    packed = (px[:, 0] << 16) | (px[:, 1] << 8) | px[:, 2] | (px[:, 3] << 24)
    n = len(packed)
    # Tokenize: windowed LZ77 (the C++ hash-chain matcher).
    lens, dists = _tokenize(packed)
    pos = np.zeros(len(lens), np.int64)
    np.cumsum(lens[:-1], out=pos[1:])
    is_lit = lens == 1
    literals_idx = pos[is_lit]

    g = px[:, 1]
    r = px[:, 0]
    b = px[:, 2]
    a = px[:, 3]

    # Color cache: exact hit detection, kept only when the entropy estimate
    # says it pays for itself (extra g-tree symbols vs dropped R/B/A codes).
    use_cache = False
    if cache_bits:
        fg_nc = np.bincount(g[literals_idx], minlength=256).astype(np.int64)
        fr_nc = np.bincount(r[literals_idx], minlength=256).astype(np.int64)
        fb_nc = np.bincount(b[literals_idx], minlength=256).astype(np.int64)
        fa_nc = np.bincount(a[literals_idx], minlength=256).astype(np.int64)
        no_cache_bits = sum(map(_entropy_bits, (fg_nc, fr_nc, fb_nc, fa_nc)))
        # Sweep the cache size: more bits -> more hits but a wider (sparser)
        # symbol alphabet; the entropy estimate picks per image.
        best_bits = None
        best_est = no_cache_bits
        for cb in range(4, cache_bits + 1):
            hits_all, hashes_all = _cache_hits(packed, cb)
            hit = hits_all[literals_idx]
            hsh = hashes_all[literals_idx]
            miss = ~hit
            fg_c = np.zeros(280 + (1 << cb), np.int64)
            np.add.at(fg_c, g[literals_idx][miss], 1)
            np.add.at(fg_c, 280 + hsh[hit], 1)
            fr_c = np.bincount(r[literals_idx][miss], minlength=256).astype(np.int64)
            fb_c = np.bincount(b[literals_idx][miss], minlength=256).astype(np.int64)
            fa_c = np.bincount(a[literals_idx][miss], minlength=256).astype(np.int64)
            est = sum(map(_entropy_bits, (fg_c, fr_c, fb_c, fa_c))) + (1 << cb) * 0.5
            if est < best_est:
                best_est = est
                best_bits = cb
                lit_hit, lit_hash = hit, hsh
        if best_bits is not None:
            use_cache = True
            cache_bits = best_bits

    # Per-token symbols (group-independent).
    alpha_g = 280 + ((1 << cache_bits) if use_cache else 0)
    lit_g_sym = g[literals_idx].copy()
    if use_cache:
        lit_g_sym[lit_hit] = 280 + lit_hash[lit_hit]
        lit_miss = ~lit_hit
    else:
        lit_miss = np.ones(len(literals_idx), bool)

    # Copy tokens: length prefix symbols on the green tree, distance prefix
    # symbols (plane-code mapped) on the distance tree.
    cp_len = lens[~is_lit]
    cp_dist = dists[~is_lit]
    len_sym, len_eb = _length_to_symbol(cp_len)
    len_sym = np.where(cp_len <= 4, cp_len - 1, len_sym)
    len_eb = np.where(cp_len <= 4, 0, len_eb)
    plane = _distance_to_plane_code(cp_dist, w)
    d_sym, d_eb = _length_to_symbol(plane)
    d_sym = np.where(plane <= 4, plane - 1, d_sym)
    d_eb = np.where(plane <= 4, 0, d_eb)

    # Meta-Huffman: spatially cluster token histograms into entropy groups
    # (ARGB top-level streams only; the flag doesn't exist for sub-streams).
    lit_grp = np.zeros(len(literals_idx), np.int64)
    cp_grp = np.zeros(len(cp_len), np.int64)
    meta = None
    if is_argb:
        meta = _meta_cluster(
            literals_idx, lit_g_sym, lit_miss,
            r[literals_idx], b[literals_idx], a[literals_idx],
            pos[~is_lit], len_sym, d_sym, w, n // max(w, 1), alpha_g,
        )
    K = 1
    if meta is not None:
        histo_bits, group_of_tile, K = meta
        bwE = _subsample_enc(w, histo_bits)

        def grp_of(p):
            return group_of_tile[
                ((p // w) >> histo_bits) * bwE + ((p % w) >> histo_bits)
            ]

        lit_grp = grp_of(literals_idx)
        cp_grp = grp_of(pos[~is_lit])

    if use_cache:
        bs.append_bits(1, 1)
        bs.append_bits(cache_bits, 4)
    else:
        bs.append_bits(0, 1)  # no color cache
    if is_argb:
        if meta is not None:
            bs.append_bits(1, 1)
            bs.append_bits(histo_bits - 2, 3)
            bhE = _subsample_enc(n // max(w, 1), histo_bits)
            ent_px = np.zeros((bhE * bwE, 4), np.int64)
            ent_px[:, 0] = group_of_tile >> 8
            ent_px[:, 1] = group_of_tile & 0xFF
            _write_image_stream(bs, ent_px, bwE, cache_bits=0, is_argb=False)
        else:
            bs.append_bits(0, 1)  # no meta-huffman

    # Per-group histograms and trees.
    freq_g = np.zeros((K, alpha_g), np.int64)
    freq_r = np.zeros((K, 256), np.int64)
    freq_b = np.zeros((K, 256), np.int64)
    freq_a = np.zeros((K, 256), np.int64)
    freq_d = np.zeros((K, 40), np.int64)
    np.add.at(freq_g, (lit_grp, lit_g_sym), 1)
    np.add.at(freq_r, (lit_grp[lit_miss], r[literals_idx][lit_miss]), 1)
    np.add.at(freq_b, (lit_grp[lit_miss], b[literals_idx][lit_miss]), 1)
    np.add.at(freq_a, (lit_grp[lit_miss], a[literals_idx][lit_miss]), 1)
    np.add.at(freq_g, (cp_grp, 256 + len_sym), 1)
    np.add.at(freq_d, (cp_grp, d_sym), 1)

    len_g = np.zeros((K, alpha_g), np.int64)
    code_g = np.zeros((K, alpha_g), np.int64)
    len_r = np.zeros((K, 256), np.int64)
    code_r = np.zeros((K, 256), np.int64)
    len_b = np.zeros((K, 256), np.int64)
    code_b = np.zeros((K, 256), np.int64)
    len_a = np.zeros((K, 256), np.int64)
    code_a = np.zeros((K, 256), np.int64)
    len_d = np.zeros((K, 40), np.int64)
    code_d = np.zeros((K, 40), np.int64)
    for k in range(K):
        len_g[k], code_g[k] = write_huffman_tree(bs, freq_g[k])
        len_r[k], code_r[k] = write_huffman_tree(bs, freq_r[k])
        len_b[k], code_b[k] = write_huffman_tree(bs, freq_b[k])
        len_a[k], code_a[k] = write_huffman_tree(bs, freq_a[k])
        len_d[k], code_d[k] = write_huffman_tree(bs, freq_d[k])

    # Emit the token stream as fixed 4-slot records (zero-width slots drop
    # out in BitStream packing): literal = G,R,B,A (or one cache symbol);
    # copy = length prefix, length extra, distance prefix, distance extra.
    nt = len(lens)
    codes4 = np.zeros((nt, 4), np.int64)
    bits4 = np.zeros((nt, 4), np.int64)

    li = literals_idx
    lit_codes = np.stack(
        [
            code_g[lit_grp, lit_g_sym],
            code_r[lit_grp, r[li]],
            code_b[lit_grp, b[li]],
            code_a[lit_grp, a[li]],
        ],
        axis=1,
    )
    lit_bits = np.stack(
        [
            len_g[lit_grp, lit_g_sym],
            len_r[lit_grp, r[li]],
            len_b[lit_grp, b[li]],
            len_a[lit_grp, a[li]],
        ],
        axis=1,
    )
    # Cache-hit literals collapse to the single g-tree symbol already in
    # lit_g_sym; blank the R/B/A slots.
    if use_cache:
        hit = (~lit_miss)[:, None]
        keep = np.array([True, False, False, False])[None, :]
        lit_codes = np.where(hit & ~keep, 0, lit_codes)
        lit_bits = np.where(hit & ~keep, 0, lit_bits)
    codes4[is_lit] = lit_codes
    bits4[is_lit] = lit_bits

    if len(cp_len):
        gsym = 256 + len_sym
        codes4[~is_lit] = np.stack(
            [
                code_g[cp_grp, gsym],
                (cp_len - 1) & ((1 << len_eb) - 1),
                code_d[cp_grp, d_sym],
                (plane - 1) & ((1 << d_eb) - 1),
            ],
            axis=1,
        )
        bits4[~is_lit] = np.stack(
            [len_g[cp_grp, gsym], len_eb, len_d[cp_grp, d_sym], d_eb], axis=1
        )

    bs.append(codes4.reshape(-1), bits4.reshape(-1))


def _meta_cluster(lit_pos, lit_g_sym, lit_miss, lit_r, lit_b, lit_a,
                  cp_pos, len_sym, d_sym, w: int, h: int, alpha_g: int):
    """Cluster per-tile token histograms into entropy groups.

    Assignment iterates on actual Huffman code lengths (each tile moves to
    the group whose trees code it cheapest), the clustering analogue of
    cwebp's histogram-combine. Returns (histo_bits, group_of_tile, K) or
    None when one group is estimated cheaper (small images, uniform stats).
    """
    if w < 1 or h < 1:
        return None
    histo_bits = 4
    while _subsample_enc(w, histo_bits) * _subsample_enc(h, histo_bits) > 400:
        histo_bits += 1
    bwE = _subsample_enc(w, histo_bits)
    bhE = _subsample_enc(h, histo_bits)
    n_tiles = bwE * bhE
    if n_tiles < 8:
        return None

    def tile_of(p):
        return ((p // w) >> histo_bits) * bwE + ((p % w) >> histo_bits)

    # Per-tile histograms over the 5 alphabets, concatenated.
    offs = np.cumsum([0, alpha_g, 256, 256, 256, 40])
    A = int(offs[-1])
    th = np.zeros((n_tiles, A), np.int64)
    lt = tile_of(lit_pos)
    np.add.at(th, (lt, lit_g_sym), 1)
    np.add.at(th, (lt[lit_miss], offs[1] + lit_r[lit_miss]), 1)
    np.add.at(th, (lt[lit_miss], offs[2] + lit_b[lit_miss]), 1)
    np.add.at(th, (lt[lit_miss], offs[3] + lit_a[lit_miss]), 1)
    ct = tile_of(cp_pos)
    np.add.at(th, (ct, 256 + len_sym), 1)
    np.add.at(th, (ct, offs[4] + d_sym), 1)

    def group_codelens(assign, K):
        """[K, A] code lengths of each group's 5 trees (15 = unseen)."""
        gh = np.zeros((K, A), np.int64)
        np.add.at(gh, assign, th)
        cl = native.vp8l_huffman_lengths(gh, offs.astype(np.int32), 15).astype(np.float64)
        # Single-symbol trees code for free; unseen symbols cost 15.
        for s, e in zip(offs[:-1], offs[1:]):
            single = (gh[:, s:e] > 0).sum(1) == 1
            cl[single, s:e] = 0.0
        cl[gh == 0] = 15.0
        return cl

    K = min(16, n_tiles)
    # Initialize by total-count quantiles (busy tiles spread across groups).
    order = np.argsort(th.sum(1), kind="stable")
    assign = np.zeros(n_tiles, np.int64)
    assign[order] = (np.arange(n_tiles) * K) // n_tiles
    for _ in range(4):
        cl = group_codelens(assign, K)
        cost = th @ cl.T  # [n_tiles, K]
        new_assign = np.argmin(cost, axis=1)
        if (new_assign == assign).all():
            break
        assign = new_assign
    # Compact group ids.
    used = np.unique(assign)
    remap = np.zeros(used.max() + 1, np.int64)
    remap[used] = np.arange(len(used))
    assign = remap[assign]
    K = len(used)
    if K == 1:
        return None

    # Gate: grouped token bits + overhead must beat one global group.
    cl = group_codelens(assign, K)
    bits_meta = float((th * cl[assign]).sum())
    cl1 = group_codelens(np.zeros(n_tiles, np.int64), 1)
    bits_one = float((th * cl1[0]).sum())
    # Overhead: ~5.5 bits per extra nonzero tree symbol, ~60 bits of fixed
    # header per tree (5 trees/group), plus the entropy image itself.
    gh = np.zeros((K, A), np.int64)
    np.add.at(gh, assign, th)
    tree_bits = 5.5 * float((gh > 0).sum() - (cl1[0] < 15).sum())
    tree_bits += (K - 1) * 5 * 60
    ent_img_bits = n_tiles * max(1.0, np.log2(K)) + 300
    if bits_meta + tree_bits + ent_img_bits >= bits_one - 512:
        return None
    return histo_bits, assign, K


def _tokenize(packed: np.ndarray):
    """Factor the pixel stream into (lens, dists) tokens: len==1 literals,
    len>=2 backref copies, by the C++ windowed LZ77 (a single pixel is one
    literal)."""
    return native.vp8l_lz77(packed.astype(np.uint32))


def _distance_to_plane_code(dist: np.ndarray, width: int) -> np.ndarray:
    """Map linear backref distances to VP8L plane codes: the 120-entry 2D
    neighborhood map when applicable (smaller symbols), else dist+120."""
    lut_size = 8 + 7 * width + 2
    lut = np.zeros(lut_size, np.int64)
    for i, (xoff, yoff) in enumerate(DISTANCE_MAP):
        d = max(xoff + yoff * width, 1)
        if d < lut_size and lut[d] == 0:
            lut[d] = i + 1
    dist = dist.astype(np.int64)
    in_lut = dist < lut_size
    mapped = np.where(in_lut, lut[np.minimum(dist, lut_size - 1)], 0)
    return np.where(mapped > 0, mapped, dist + 120)


def near_lossless_preprocess(rgba: np.ndarray, quality: int) -> np.ndarray:
    """Near-lossless pre-quantization (libwebp near_lossless_enc.c model).

    quality 100..0 -> 0..5 bits of channel quantization, applied only to
    pixels in non-smooth neighborhoods (a pixel whose 4-neighborhood is
    flat in every channel is left exact, so gradients don't band). The
    discretization rounds to the nearest multiple of 2^bits with the
    libwebp anti-banding bias."""
    bits = min(5, max(0, (100 - int(quality)) // 20))
    if bits == 0:
        return rgba
    h, w = rgba.shape[:2]
    if h < 3 or w < 3:
        return rgba
    px = rgba.astype(np.int32)
    out = rgba.copy()

    # Smooth = all 4-neighbors equal to the pixel in every channel.
    center = px[1:-1, 1:-1]
    smooth = (
        (px[:-2, 1:-1] == center).all(-1)
        & (px[2:, 1:-1] == center).all(-1)
        & (px[1:-1, :-2] == center).all(-1)
        & (px[1:-1, 2:] == center).all(-1)
    )

    mask = (1 << bits) - 1
    biased = center + (mask >> 1) + ((center >> bits) & 1)
    quant = np.where(biased > 0xFF, 0xFF, biased & ~mask).astype(np.uint8)
    out[1:-1, 1:-1] = np.where(smooth[..., None], out[1:-1, 1:-1], quant)
    return out


def encode_alpha_lossless(alpha_plane: np.ndarray) -> bytes:
    """ALPH chunk payload: VP8L-compressed alpha in the green channel."""
    h, w = alpha_plane.shape
    rgba = np.empty((h, w, 4), np.uint8)
    # L8 expansion (r=g=b=value) so subtract-green zeroes R and B.
    rgba[:, :, 0] = rgba[:, :, 1] = rgba[:, :, 2] = alpha_plane
    rgba[:, :, 3] = 255
    # header byte: compression=1 (lossless), no filtering, no preprocessing
    payload = encode_lossless(rgba, use_predictor=True, implicit_dims=True)
    return b"\x01" + payload

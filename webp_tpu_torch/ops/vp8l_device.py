"""Kernels K9-K12: the VP8L (lossless) inverse transforms, batched.

Replace `webp_tpu/ops/vp8l_device.py`: K9 `subtract_green` (:45), K10
`color_transform` (:51), K11 `color_indexing` (:74) and K12
`inverse_predictor_batch` (:159).  The CUDA kernels are `csrc/vp8l.cu`;
each `*_plain` function beside its wrapper is the kernel's torch twin.

Pixels are uint8 [B, h, w, 4] in R, G, B, A byte order, contiguous.  K9,
K10 and K12 work in place (the JAX functions return new arrays); K11
returns a new, wider tensor.  A wrapper takes its twin for CPU tensors and
launches its kernel for CUDA tensors.  K12 has a second twin,
`inverse_predictor_rows_plain_`, that walks the kernel's schedule of row
bands and hand-overs.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build

_MODE_ZERO = 14  # predictor modes 14 and 15 (and any larger) add zero

# K12's schedule (csrc/vp8l.cu): a warp runs a band of BAND rows, one lane a
# row; a CTA stacks WARPS bands; a band stages its tiles CHUNK steps at a
# time, hands its bottom row on every SUB steps and trails the band above by
# LAG sub-chunks; the shared edge rings hold EDGE_RING columns.
BAND, WARPS, CHUNK, SUB, LAG, EDGE_RING = 32, 4, 32, 8, 8, 256
SPAN = 2 * (BAND - 1)  # steps from a band's top lane to its bottom lane


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


# K11's schedule (csrc/vp8l.cu): a CTA of INDEX_THREADS threads per run of
# `index_rows` rows of an image; a thread per group of 4 output pixels (8 at
# 8 indices a byte) on the output's 16-byte lattice.
INDEX_THREADS = 256


def index_rows(width: int, h: int) -> int:
    """Rows of a K11 CTA: the fewest (a power of two, at most h) whose
    output is at least 16 KB."""
    rows = 1
    while rows < h and rows * width < 4096:
        rows <<= 1
    return min(rows, h)


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


def predictor_bands(h: int, warps: int = WARPS) -> int:
    """K12's CTAs for an image of h rows: bands of warps * BAND rows."""
    return -(-h // (warps * BAND))


def inverse_predictor_rows_plain_(px: torch.Tensor, modes: torch.Tensor, size_bits: int,
                                  seed: int = 0, lag: int = LAG, warps: int = WARPS,
                                  resident: int | None = None) -> torch.Tensor:
    """K12's schedule on the host, in place: the kernel's units (each CTA's
    band warps, its inbound and its outbound warp) run sub-chunk by
    sub-chunk in an order drawn from numpy RandomState(seed), each waiting
    where the kernel waits.  A band's lanes step together (lane r at pixel
    s - 2r) and take their neighbours where the kernel does: the left from
    the lane's own history, the top-right, top and top-left from lane r - 1's
    (`__shfl_up_sync`), lane 0's from the shared edge ring of the band above,
    which for band 0 of a CTA the inbound warp fills from the global edge row
    that the outbound warp of the CTA above publishes.  A band publishes its
    bottom row's columns after every SUB steps; its sub-chunk at step sq
    starts once the row above has SUB * (sq / SUB + lag + 1) - SPAN columns
    (capped at w), and a writer stays a ring ahead of its reader at most.
    CTAs start in ticket order, at most `resident` at once.  The rings start
    zeroed, so a read ahead of the writer shows.  Equals
    `inverse_predictor_plain_` for every seed at the kernel's lag."""
    B, h, w = px.shape[:3]
    dev = px.device
    nb = predictor_bands(h, warps)
    rng = np.random.RandomState(seed)
    lane = torch.arange(BAND, device=dev)
    bidx = torch.arange(B, device=dev)[:, None]
    mode_map = modes.to(torch.int64)
    gedge = torch.zeros((B, nb, w, 4), dtype=torch.int32, device=dev)
    prog = [0] * nb

    def shfl_up(t):  # lane r takes lane r - 1's value; lane 0 keeps its own
        return torch.cat([t[:, :1], t[:, :-1]], 1)

    def cta(j: int):
        edge = torch.zeros((warps + 1, B, EDGE_RING, 4), dtype=torch.int32, device=dev)
        made, used = [0] * (warps + 1), [0] * (warps + 1)

        def band(k: int):
            y0 = (j * warps + k) * BAND
            if y0 >= h:
                return
            rows = min(BAND, h - y0)
            y = y0 + lane
            yc = y.clamp(max=h - 1)
            live = lane < rows
            feeds = y0 + BAND < h if k + 1 < warps else j + 1 < nb
            n_chunks = -(-(w + 2 * (rows - 1)) // CHUNK)
            h1 = h2 = h3 = first = torch.zeros((B, BAND, 4), dtype=torch.int32, device=dev)
            te = tle = torch.zeros((B, 4), dtype=torch.int32, device=dev)
            ev = torch.zeros((B, SUB, 4), dtype=torch.int32, device=dev)
            for c in range(n_chunks):
                s0 = CHUNK * c
                if y0 > 0 and c > 0:
                    used[k] = min(w, s0 + 1)
                if feeds:
                    hi = min(w, s0 + CHUNK - SPAN)
                    yield lambda: hi <= used[k + 1] + EDGE_RING
                for sq in range(s0, s0 + CHUNK, SUB):
                    if y0 > 0:
                        need = min(w, sq + SUB * (lag + 1) - SPAN)
                        yield lambda: made[k] >= need
                        if sq == 0:
                            te = edge[k][:, 0].clone()
                        ev = edge[k][:, (sq + 1 + torch.arange(SUB, device=dev)) % EDGE_RING]
                    else:
                        yield lambda: True
                    for i in range(SUB):
                        s = sq + i
                        x = s - 2 * lane
                        tr_e = ev[:, i]
                        up_tr, up_t, up_tl = shfl_up(h1), shfl_up(h2), shfl_up(h3)
                        top = (lane > 0)[None, :, None]
                        T = torch.where(top, up_t, te[:, None])
                        TL = torch.where(top, up_tl, tle[:, None])
                        TR = torch.where((x + 1 < w)[None, :, None],
                                         torch.where(top, up_tr, tr_e[:, None]), first)
                        tle, te = te, tr_e
                        xc = x.clamp(0, w - 1)
                        res = px[bidx, yc[None], xc[None]].to(torch.int32)
                        mode = mode_map[bidx, (yc >> size_bits)[None], (xc >> size_bits)[None]]
                        mode = torch.where((y == 0)[None], torch.where((x == 0)[None], 0, 1),
                                           torch.where((x == 0)[None], 2, mode))
                        out = (res + predict(mode, h1, T, TL, TR)) & 0xFF
                        ok = live & (x >= 0) & (x < w)
                        px[bidx, yc[ok][None], xc[ok][None]] = out[:, ok].to(torch.uint8)
                        if feeds and ok[BAND - 1]:
                            edge[k + 1][:, int(x[BAND - 1]) % EDGE_RING] = out[:, BAND - 1]
                        first = torch.where((x == 0)[None, :, None], out, first)
                        h1, h2, h3 = out, h1, h2
                    if feeds:
                        made[k + 1] = max(0, min(w, sq + SUB - SPAN))

        def inbound():
            if j == 0:
                return
            done = 0
            while done < w:
                yield lambda: min(prog[j - 1], used[0] + EDGE_RING) > done
                avail = min(prog[j - 1], used[0] + EDGE_RING)
                cols = torch.arange(done, avail, device=dev)
                edge[0][:, cols % EDGE_RING] = gedge[:, j - 1, cols]
                made[0] = done = avail

        def outbound():
            if j + 1 >= nb:
                return
            done = 0
            while done < w:
                yield lambda: made[warps] > done
                avail = made[warps]
                cols = torch.arange(done, avail, device=dev)
                gedge[:, j, cols] = edge[warps][:, cols % EDGE_RING]
                used[warps] = prog[j] = done = avail

        return [band(k) for k in range(warps)] + [inbound(), outbound()]

    units = []  # [generator, its wait, its CTA]

    def advance(u) -> bool:
        try:
            u[1] = next(u[0])
            return True
        except StopIteration:
            return False

    next_cta = 0
    while next_cta < nb or units:
        active = {u[2] for u in units}
        options = [u for u in units if u[1]()]
        can_start = next_cta < nb and (resident is None or len(active) < resident)
        if not options and not can_start:
            raise RuntimeError("K12's schedule waits on itself")
        pick = rng.randint(len(options) + can_start)
        if pick == len(options):
            fresh = [[g, None, next_cta] for g in cta(next_cta)]
            units += [u for u in fresh if advance(u)]
            next_cta += 1
        elif not advance(options[pick]):
            units.remove(options[pick])
    return px


def inverse_predictor_(px: torch.Tensor, modes: torch.Tensor, size_bits: int) -> torch.Tensor:
    """Inverse predictor transform, in place: px holds the residuals, modes
    [B, bh, bw] uint8 the predictor image's green channel (2 <= size_bits
    <= 9).  Pixel (0, 0) adds opaque black, the rest of row 0 its left
    neighbour, the rest of column 0 its top; the last column's top-right is
    the first pixel of its own row.  On a card the row-band kernel runs
    B * predictor_bands(h) CTAs, with a global edge row and a progress
    counter for each (and the ticket) as scratch."""
    B, h, w = _pixels(px)
    if not 2 <= size_bits <= 9:
        raise ValueError(f"size_bits {size_bits} outside 2..9")
    shape = (B, subsample(h, size_bits), subsample(w, size_bits))
    dev = _build.same_device(px, modes)
    if dev.type == "cpu":
        if tuple(modes.shape) != shape:
            raise ValueError(f"predictor modes must be {shape}, got {tuple(modes.shape)}")
        return inverse_predictor_plain_(px, modes, size_bits)
    nb = predictor_bands(h)
    gedge = torch.empty(B * nb * w if nb > 1 else 1, dtype=torch.int32, device=dev)
    prog = torch.zeros(B * nb + 1, dtype=torch.int32, device=dev)
    _build.launch("predictor", "webp_vp8l_predictor", dev, px.data_ptr(),
                  _build.dense(modes, torch.uint8, shape), size_bits, w, h, B,
                  gedge.data_ptr(), prog.data_ptr())
    return px


def resident_ctas(device) -> int:
    """K12 CTAs that `device` keeps resident at once (the occupancy API)."""
    lib = _build.load()
    with torch.cuda.device(device):
        n = lib.webp_vp8l_predictor_resident()
    if n < 0:
        raise RuntimeError("webp_vp8l_predictor_resident: occupancy query failed")
    return n

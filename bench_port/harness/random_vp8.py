"""Seeded random VP8 keyframes, written without an encoder: a frozen copy of
`tests/random_vp8.py`, with its tables from the reference's copy and the
length of a block's coded run a parameter (`run_p`).

`random_keyframe(width, height, seed)` draws a keyframe's header and its
per-macroblock content from a numpy seed and writes them with a boolean
encoder (RFC 6386) into a valid VP8 payload:

- header: quantizer index and deltas, segments (absolute or delta values,
  map probabilities), loop filter kind (`simple`), level and sharpness,
  mode / reference filter deltas, 1 to 8 token partitions, and some
  updated token probabilities;
- per MB: segment, luma mode (about 30% B-predicted, with sixteen random
  sub-block modes), chroma mode, and quantized levels whose density and
  sizes are near those of a Q75 photo (~42 KB per 768x512 frame at the
  default `run_p`, ~77 KB at 0.17), with
  `escapes` levels of |level| > 127 placed on purpose.  A few MBs are all
  zero; most of those are coded as skipped.

The decoded picture is noise: the point is that every path of a decoder
sees real bitstream syntax, at any size, with no encoder in the loop.
"""

from __future__ import annotations

import numpy as np

from vp8ref.common import vp8_tables as T

# DCT token tree: leaves EOB, ZERO, ONE, TWO, THREE, FOUR, CAT1..CAT6 (0..11).
_TOKEN_TREE = (-0, 2, -1, 4, -2, 6, 8, 12, -3, 10, -4, -5, 14, 16, -6, -7, 18, 20,
               -8, -9, -10, -11)
_EOB, _ZERO, _CAT1 = 0, 1, 6
_CAT_MAX = (6, 10, 18, 34, 66, 2048 + 66)
# Sub-block mode implied by each 16x16 luma mode (DC, V, H, TM) for the
# B-mode contexts of later MBs: B_DC, B_VE, B_HE, B_TM.
_IMPLIED_BMODE = (0, 2, 3, 1)


def _paths(tree, start=0):
    """leaf -> ((bit, prob index), ...) from node `start` of a coding tree."""
    out = {}

    def walk(i, prefix):
        for bit in (0, 1):
            t = tree[i + bit]
            step = prefix + ((bit, i >> 1),)
            if t <= 0:
                out[-t] = step
            else:
                walk(t, step)

    walk(start, ())
    return out


_TOKEN_PATHS = (_paths(_TOKEN_TREE, 0), _paths(_TOKEN_TREE, 2))
_YMODE_PATHS = _paths(T.KEYFRAME_YMODE_TREE)
_BMODE_PATHS = _paths(T.KEYFRAME_BPRED_MODE_TREE)
_UV_PATHS = _paths(T.KEYFRAME_UV_MODE_TREE)
_SEG_PATHS = _paths(T.SEGMENT_ID_TREE)


class BoolEncoder:
    """VP8 boolean encoder (RFC 6386 section 7.3) with carry propagation."""

    def __init__(self):
        self.out = bytearray()
        self.bottom = 0
        self.range = 255
        self.bit_num = 24

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def bool(self, bit, prob: int):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_num -= 1
            if self.bit_num == 0:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_num = 8

    def literal(self, nbits: int, value):
        value = int(value)
        for b in range(nbits - 1, -1, -1):
            self.bool((value >> b) & 1, 128)

    def signed(self, nbits: int, value: int):
        """Optional signed field: present flag, magnitude, sign."""
        self.literal(1, value != 0)
        if value:
            self.literal(nbits, abs(value))
            self.literal(1, value < 0)

    def tree(self, path, probs):
        for bit, node in path:
            self.bool(bit, int(probs[node]))

    def flush(self) -> bytes:
        for _ in range(32):  # push the last bits out through the carry logic
            self.bool(0, 128)
        return bytes(self.out)


def _write_block(enc, zz, plane_probs, first: int, ctx: int):
    """Tokens of one block of zigzag-order levels (RFC 6386 section 13)."""
    nz = np.flatnonzero(zz)
    end = int(nz[-1]) + 1 if len(nz) else 0
    after_zero = False
    for i in range(first, end):
        p = plane_probs[T.COEFF_BANDS[i]][ctx]
        v = abs(int(zz[i]))
        if v <= 4:
            tok = _ZERO + v
        else:
            tok = _CAT1 + next(c for c, top in enumerate(_CAT_MAX) if v <= top)
        enc.tree(_TOKEN_PATHS[after_zero][tok], p)
        if tok == _ZERO:
            after_zero, ctx = True, 0
            continue
        after_zero = False
        if tok >= _CAT1:
            cat = tok - _CAT1
            probs = T.PROB_DCT_CAT[cat]
            extra = v - T.DCT_CAT_BASE[cat]
            for j, prob in enumerate(probs):
                enc.bool((extra >> (len(probs) - 1 - j)) & 1, prob)
        enc.literal(1, zz[i] < 0)
        ctx = 1 if v == 1 else 2
    if end < 16:
        enc.tree(_TOKEN_PATHS[0][_EOB], plane_probs[T.COEFF_BANDS[max(first, end)]][ctx])
    return end > first


def random_content(rng, mbw: int, mbh: int, escapes: int = 8, dense: bool = False,
                   run_p: float = 0.3):
    """Per-MB arrays of a random frame: luma_mode, bpred [nmb, 16],
    chroma_mode, segment_ids, skipped, and levels int32 [nmb, 25, 16] in
    zigzag (token) order, blocks 0-15 Y, 16-23 U then V, 24 Y2.

    `escapes` levels get |level| in [128, 2047].  With `dense`, the first
    MB codes all 384 of its Y / U / V levels (more than the 256 nonzeros
    the sparse upload takes per MB).  A block's coded run is geometric
    with parameter `run_p`: the smaller, the more levels a frame codes.
    """
    nmb = mbw * mbh
    luma_mode = np.where(rng.rand(nmb) < 0.3, 4, rng.randint(0, 4, nmb))
    luma_mode[0] = 4  # both kinds in every frame
    luma_mode[-1] = rng.randint(0, 4)
    i4 = luma_mode == 4

    # Levels: a geometric run of coded positions per block, most of them
    # small, some mid-size (the extra-bit token categories).
    end = np.minimum(16, rng.geometric(run_p, (nmb, 25)) - 1)
    end[rng.rand(nmb, 25) < 0.35] = 0
    pos = np.arange(16)
    coded = pos < end[..., None]
    mag = rng.geometric(0.6, (nmb, 25, 16))
    mid = rng.rand(nmb, 25, 16) < 0.03
    mag[mid] = rng.randint(5, 67, mid.sum())
    mag[rng.rand(nmb, 25, 16) < 0.25] = 0
    mag[pos == end[..., None] - 1] = np.maximum(mag[pos == end[..., None] - 1], 1)
    levels = np.where(coded, mag, 0) * rng.choice([-1, 1], (nmb, 25, 16))
    levels[i4, 24] = 0          # B-predicted MBs have no Y2 block
    levels[~i4, :16, 0] = 0     # the Y2 block carries the other MBs' Y DCs
    if dense:
        levels[0, :24] = rng.randint(1, 5, (24, 16)) * rng.choice([-1, 1], (24, 16))
        levels[0, :16, 0] *= luma_mode[0] == 4
    zero_mb = rng.rand(nmb) < 0.05
    zero_mb[0] = False
    levels[zero_mb] = 0
    for _ in range(escapes):
        m = rng.randint(1, nmb) if nmb > 1 else 0
        b = rng.randint(0, 24) if i4[m] else rng.randint(0, 25)
        p = rng.randint(0 if (i4[m] or b >= 16) else 1, 16)
        levels[m, b, p] = rng.randint(128, 2048) * rng.choice([-1, 1])
    skipped = ~levels.any(axis=(1, 2)) & (rng.rand(nmb) < 0.8)
    return dict(
        luma_mode=luma_mode, bpred=rng.randint(0, 10, (nmb, 16)),
        chroma_mode=rng.randint(0, 4, nmb), segment_ids=rng.randint(0, 4, nmb),
        skipped=skipped, levels=levels.astype(np.int32),
    )


def _frame_header(enc, rng, simple: bool, log2_parts: int, probs):
    """Bool-coded frame header (RFC 6386 section 9.2-9.11, 19.2); returns
    whether the segment map is coded and the segment tree probabilities."""
    enc.literal(1, 0)  # colour space
    enc.literal(1, 0)  # clamping type: the decoder clamps
    segments = rng.rand() < 0.85
    enc.literal(1, segments)
    seg_probs = np.full(3, 255)
    if segments:
        enc.literal(1, 1)  # update the map
        enc.literal(1, 1)  # update the data
        absolute = rng.rand() < 0.3
        enc.literal(1, absolute)
        for _ in range(4):
            enc.signed(7, rng.randint(0, 128) if absolute else rng.randint(-15, 16))
        for _ in range(4):
            enc.signed(6, rng.randint(0, 64) if absolute else rng.randint(-15, 16))
        for i in range(3):
            present = rng.rand() < 0.8
            enc.literal(1, present)
            if present:
                seg_probs[i] = rng.randint(1, 256)
                enc.literal(8, seg_probs[i])
    enc.literal(1, simple)
    enc.literal(6, rng.randint(8, 64))  # filter level
    enc.literal(3, rng.randint(0, 8))   # sharpness
    adjust = rng.rand() < 0.5
    enc.literal(1, adjust)
    if adjust:
        enc.literal(1, 1)  # update the deltas
        for _ in range(8):  # 4 reference-frame, then 4 mode deltas
            enc.signed(6, rng.randint(-20, 21) if rng.rand() < 0.6 else 0)
    enc.literal(2, log2_parts)
    enc.literal(7, rng.randint(8, 64))  # base quantizer index (Q75 is ~26)
    for _ in range(5):  # y_dc, y2_dc, y2_ac, uv_dc, uv_ac deltas
        enc.signed(4, rng.randint(-15, 16) if rng.rand() < 0.4 else 0)
    enc.literal(1, rng.randint(2))  # refresh entropy probs
    update = rng.rand(*probs.shape) < 0.01
    for idx in np.ndindex(probs.shape):
        enc.bool(int(update[idx]), int(T.COEFF_UPDATE_PROBS[idx]))
        if update[idx]:
            probs[idx] = rng.randint(1, 256)
            enc.literal(8, int(probs[idx]))
    enc.literal(1, 1)  # MB skip flags coded
    return segments, seg_probs


def write_keyframe(width: int, height: int, content, rng, simple=False, log2_parts=0) -> bytes:
    """VP8 keyframe payload of `content` (see `random_content`); the frame
    header's fields are drawn from `rng`."""
    mbw, mbh = (width + 15) // 16, (height + 15) // 16
    probs = T.COEFF_PROBS_DEFAULT.astype(np.int32).copy()
    first = BoolEncoder()
    segments, seg_probs = _frame_header(first, rng, simple, log2_parts, probs)
    skip_prob = int(rng.randint(100, 250))
    first.literal(8, skip_prob)

    lm, bp, cm = content["luma_mode"], content["bpred"], content["chroma_mode"]
    sid, skipped, levels = content["segment_ids"], content["skipped"], content["levels"]
    parts = [BoolEncoder() for _ in range(1 << log2_parts)]
    top_b = np.zeros(mbw * 4, np.int64)
    top_nz = np.zeros((mbw, 9), np.int64)  # per MB column: Y x4, U x2, V x2, Y2
    for mby in range(mbh):
        enc = parts[mby % len(parts)]
        left_b = np.zeros(4, np.int64)
        left_nz = np.zeros(9, np.int64)
        for mbx in range(mbw):
            i = mby * mbw + mbx
            # MB header, into the first partition.
            if segments:
                first.tree(_SEG_PATHS[int(sid[i])], seg_probs)
            first.bool(int(skipped[i]), skip_prob)
            first.tree(_YMODE_PATHS[int(lm[i])], T.KEYFRAME_YMODE_PROBS)
            if lm[i] == 4:
                for s in range(16):
                    sy, sx = divmod(s, 4)
                    ctx = T.KEYFRAME_BPRED_MODE_PROBS[top_b[mbx * 4 + sx], left_b[sy]]
                    first.tree(_BMODE_PATHS[int(bp[i, s])], ctx)
                    top_b[mbx * 4 + sx] = left_b[sy] = bp[i, s]
            else:
                top_b[mbx * 4 : mbx * 4 + 4] = left_b[:] = _IMPLIED_BMODE[lm[i]]
            first.tree(_UV_PATHS[int(cm[i])], T.KEYFRAME_UV_MODE_PROBS)

            # Tokens, into the row's partition, with the non-zero contexts.
            t, l = top_nz[mbx], left_nz
            has_y2 = lm[i] != 4
            if skipped[i]:
                t[:8] = l[:8] = 0
                if has_y2:
                    t[8] = l[8] = 0
                continue
            lv = levels[i]
            if has_y2:
                t[8] = l[8] = _write_block(enc, lv[24], probs[1], 0, t[8] + l[8])
            for b in range(16):
                by, bx = divmod(b, 4)
                t[bx] = l[by] = _write_block(enc, lv[b], probs[0 if has_y2 else 3],
                                             int(has_y2), t[bx] + l[by])
            for b in range(8):
                c, (by, bx) = 4 + 2 * (b // 4), divmod(b % 4, 2)
                t[c + bx] = l[c + by] = _write_block(enc, lv[16 + b], probs[2], 0,
                                                     t[c + bx] + l[c + by])

    head = first.flush()
    streams = [p.flush() for p in parts]
    tag = (len(head) << 5) | (1 << 4)  # keyframe, version 0, shown
    out = bytearray(tag.to_bytes(3, "little"))
    out += b"\x9d\x01\x2a" + width.to_bytes(2, "little") + height.to_bytes(2, "little")
    out += head
    for s in streams[:-1]:
        out += len(s).to_bytes(3, "little")
    for s in streams:
        out += s
    return bytes(out)


def random_keyframe(width: int, height: int, seed: int, simple: bool = False,
                    log2_parts: int | None = None, escapes: int = 8, dense: bool = False,
                    run_p: float = 0.3):
    """(payload, content) of a seeded random keyframe; `log2_parts` None
    draws the number of token partitions from the seed."""
    rng = np.random.RandomState(seed)
    content = random_content(rng, (width + 15) // 16, (height + 15) // 16, escapes, dense, run_p)
    if log2_parts is None:
        log2_parts = int(rng.randint(0, 4))
    return write_keyframe(width, height, content, rng, simple, log2_parts), content

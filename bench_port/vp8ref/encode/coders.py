"""The MB-header and coefficient-partition coders in plain Python.

The Python forms of the JAX package's bitstream writer
(`webp_tpu/encode/vp8.py` `_write_bitstream_arrays`, :962-1049, and
`_write_block`, :851-883), which the port's C++ coders
(`vp8_mbheader_encode`, `vp8_token_encode`) follow byte for byte.
"""

from __future__ import annotations

import numpy as np

from ..common import vp8_tables as T
from .boolenc import BoolEncoder, flush_lane, tree_paths

_YMODE_PATHS = tree_paths(T.KEYFRAME_YMODE_TREE)[0]
_UV_PATHS = tree_paths(T.KEYFRAME_UV_MODE_TREE)[0]
_BPRED_PATHS = tree_paths(T.KEYFRAME_BPRED_MODE_TREE)[0]
_SEG_PATHS = tree_paths(T.SEGMENT_ID_TREE)[0]
_TOKEN_PATHS = tree_paths(T.DCT_TOKEN_TREE)
TOK_EOB, TOK_0, TOK_CAT1 = 0, 1, 6
_CAT_TOP = (6, 10, 18, 34, 66)
# The B mode a whole-block luma mode (DC, V, H, TM) implies for the
# contexts of later MBs: B_DC, B_VE, B_HE, B_TM.
_IMPLIED_BMODE = (0, 2, 3, 1)


def _with_path(enc: BoolEncoder, path, probs) -> None:
    for bit, node in path:
        enc.write_bool(bit, int(probs[node]))


def flush(enc: BoolEncoder) -> bytes:
    """The coder's bytes with its final registers flushed."""
    return flush_lane(enc.bottom, enc.bit_num, bytes(enc.out))


def mbheader_encode(enc: BoolEncoder, luma_mode, bpred, chroma_mode, skipped, mbw: int,
                    skip_prob: int, segment_ids, write_segments: bool, seg_tree_probs) -> bytes:
    """Continue the frame header's coder with every MB header, flush, and
    return the first partition's bytes."""
    nmb = len(luma_mode)
    top = np.zeros((mbw, 4), np.int64)
    left = np.zeros(4, np.int64)
    for i in range(nmb):
        mbx = i % mbw
        if mbx == 0:
            left[:] = 0
        if write_segments:
            _with_path(enc, _SEG_PATHS[int(segment_ids[i])], seg_tree_probs)
        enc.write_bool(1 if skipped[i] else 0, skip_prob)
        lm = int(luma_mode[i])
        _with_path(enc, _YMODE_PATHS[lm], T.KEYFRAME_YMODE_PROBS)
        if lm == 4:
            for s in range(16):
                sy, sx = divmod(s, 4)
                m = int(bpred[i, s])
                _with_path(enc, _BPRED_PATHS[m], T.KEYFRAME_BPRED_MODE_PROBS[top[mbx, sx], left[sy]])
                top[mbx, sx] = left[sy] = m
        else:
            top[mbx] = left[:] = _IMPLIED_BMODE[lm]
        _with_path(enc, _UV_PATHS[int(chroma_mode[i])], T.KEYFRAME_UV_MODE_PROBS)
    return flush(enc)


def _token_for(v: int) -> int:
    if v <= 4:
        return TOK_0 + v
    return TOK_CAT1 + next((c for c, top in enumerate(_CAT_TOP) if v <= top), 5)


def _write_block(enc: BoolEncoder, levels, plane_probs, first: int, ctx: int) -> None:
    """The tokens of one block of zigzag-order levels."""
    nz = np.flatnonzero(levels)
    end = int(nz[-1]) + 1 if len(nz) else 0
    after_zero = False
    for i in range(first, end):
        v = int(levels[i])
        a = abs(v)
        p = plane_probs[T.COEFF_BANDS[i]][ctx]
        tok = _token_for(a)
        _with_path(enc, _TOKEN_PATHS[2 if after_zero else 0][tok], p)
        if tok == TOK_0:
            after_zero, ctx = True, 0
            continue
        after_zero = False
        if tok >= TOK_CAT1:
            cat = tok - TOK_CAT1
            extra = a - T.DCT_CAT_BASE[cat]
            probs = T.PROB_DCT_CAT[cat]
            n = len(probs)
            for b in range(n - 1, -1, -1):
                enc.write_bool((extra >> b) & 1, probs[n - 1 - b])
        enc.write_bool(1 if v < 0 else 0, 128)
        ctx = 1 if a == 1 else 2
    if end < 16:
        _with_path(enc, _TOKEN_PATHS[0][TOK_EOB], plane_probs[T.COEFF_BANDS[max(first, end)]][ctx])


def token_encode(levels: np.ndarray, meta: np.ndarray, probs: np.ndarray) -> bytes:
    """One coefficient partition of [N, 16] level blocks with [N, 4] (plane,
    first, ctx, _) rows, under token probabilities [4, 8, 3, 11]."""
    enc = BoolEncoder()
    table = np.asarray(probs).astype(np.int64).tolist()
    for lv, m in zip(levels, meta):
        _write_block(enc, lv, table[int(m[0])], int(m[1]), int(m[2]))
    return flush(enc)

"""ctypes bindings for the host halves of the codec: the C++ entropy passes.

The boolean arithmetic coders and the VP8L Huffman decoder are the
codec's serial tail and run on the host.  Their sources are the repo's
`native/vp8_entropy.cpp` and `native/vp8l.cpp`; this module builds them
with g++ at first use into one library in `build/` beside the package (its
own copy, so that it never shares a library file with another process's
build) and binds the entry points the lossy decode needs (frame parse,
levels-mode entropy decode, fancy YUV->RGB), those the encode needs
(RGB->YUV420, the encode wire's expansion, token statistics, token and
MB-header coding), those the lossless decode needs (VP8L entropy pass,
full host decode) and those the lossless encoder needs (LZ77 match search,
limited Huffman code lengths, colour-cache hits, predictor choice).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from .. import _build as build
from ..common import vp8_tables as T

_ROOT = Path(__file__).resolve().parent.parent.parent
SRCS = (_ROOT / "native" / "vp8_entropy.cpp", _ROOT / "native" / "vp8l.cpp")
LIB_PATH = _ROOT / "build" / "libwebp_tpu_torch_native.so"

_lib = None
_lock = threading.Lock()

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i16p = ctypes.POINTER(ctypes.c_int16)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u32p = ctypes.POINTER(ctypes.c_uint32)



class StreamError(ValueError):
    """A C++ decoder rejected its stream; `code` is its return code."""

    def __init__(self, entry: str, code: int):
        super().__init__(f"{entry} failed: {code}")
        self.code = code


_DEFAULT_PROBS = np.ascontiguousarray(T.COEFF_PROBS_DEFAULT, dtype=np.uint8)
_UPDATE_PROBS = np.ascontiguousarray(T.COEFF_UPDATE_PROBS, dtype=np.uint8)
_BPRED_PROBS = np.ascontiguousarray(T.KEYFRAME_BPRED_MODE_PROBS, dtype=np.uint8)
_DC_Q = np.ascontiguousarray(T.DC_QUANT, dtype=np.int16)
_AC_Q = np.ascontiguousarray(T.AC_QUANT, dtype=np.int16)


def _build() -> None:
    # A temp file and an atomic rename, so that a concurrent first use never
    # loads a half-written library.
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp), *map(str, SRCS)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)
    build.write_stamp(LIB_PATH, SRCS)


def load():
    """Build (if the library is missing, from other sources, or older than
    one of them) and load it."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if build.stale(LIB_PATH, SRCS):
            _build()
        lib = ctypes.CDLL(str(LIB_PATH))
        lib.vp8_parse_dims.restype = ctypes.c_int
        lib.vp8_parse_dims.argtypes = [_u8p, ctypes.c_int, _i32p, _i32p]
        lib.vp8_entropy_decode16.restype = ctypes.c_int
        lib.vp8_entropy_decode16.argtypes = [
            _u8p, ctypes.c_int, _u8p, _u8p, _u8p, _i16p, _i16p,
            _i32p, _i32p, _u8p, _u8p, _u8p, _u8p, _u8p, _u8p, _i16p,
        ]
        lib.yuv420_to_rgb_fancy.restype = ctypes.c_int
        lib.yuv420_to_rgb_fancy.argtypes = [
            _u8p, ctypes.c_int, _u8p, _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p,
        ]
        lib.rgb_to_yuv420.restype = ctypes.c_int
        lib.rgb_to_yuv420.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                      _u8p, _u8p, _u8p]
        lib.vp8_token_stats.restype = ctypes.c_int
        lib.vp8_token_stats.argtypes = [_i32p, _i32p, ctypes.c_int, _i64p, _i64p]
        lib.vp8_token_encode.restype = ctypes.c_int
        lib.vp8_token_encode.argtypes = [_i32p, _i32p, ctypes.c_int, _u8p, _u8p, ctypes.c_int]
        lib.vp8_mbheader_encode.restype = ctypes.c_int
        lib.vp8_mbheader_encode.argtypes = [
            _u8p, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
            _i32p, _i32p, _i32p, _i32p, _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _u8p, _u8p, _u8p, ctypes.c_int,
        ]
        lib.wire_expand_levels.restype = ctypes.c_int
        lib.wire_expand_levels.argtypes = [_u8p, _u8p, _u8p, ctypes.POINTER(ctypes.c_int8),
                                           ctypes.c_int, ctypes.c_int, ctypes.c_int, _i16p]
        lib.vp8l_decode_entropy.restype = ctypes.c_int
        lib.vp8l_decode_entropy.argtypes = [_u8p, ctypes.c_int, ctypes.c_int32, ctypes.c_int32,
                                            ctypes.c_int, _u8p, _i32p, _u8p, ctypes.c_int]
        lib.vp8l_decode.restype = ctypes.c_int
        lib.vp8l_decode.argtypes = [_u8p, ctypes.c_int, ctypes.c_int32, ctypes.c_int32,
                                    ctypes.c_int, _u8p]
        lib.vp8l_lz77.restype = ctypes.c_int
        lib.vp8l_lz77.argtypes = [_u32p, ctypes.c_int, _i32p, _i32p, ctypes.c_int, ctypes.c_int]
        lib.vp8l_huffman_lengths.restype = ctypes.c_int
        lib.vp8l_huffman_lengths.argtypes = [_i64p, ctypes.c_int, ctypes.c_int, _i32p,
                                             ctypes.c_int, ctypes.c_int, _u8p]
        lib.vp8l_cache_hits.restype = ctypes.c_int
        lib.vp8l_cache_hits.argtypes = [_u32p, ctypes.c_int, ctypes.c_int, _u8p, _i32p]
        lib.vp8l_pick_predictors.restype = ctypes.c_int
        lib.vp8l_pick_predictors.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                             _u8p, _u8p, _u8p]
        _lib = lib
        return lib


def _p(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def parse_dims(payload) -> tuple[int, int]:
    """(width, height) of a VP8 payload, from its frame header; StreamError
    when the payload has no keyframe header."""
    buf = np.frombuffer(bytes(payload), np.uint8)
    w, h = ctypes.c_int32(), ctypes.c_int32()
    rc = load().vp8_parse_dims(_p(buf, ctypes.c_uint8), len(buf), ctypes.byref(w),
                               ctypes.byref(h))
    if rc != 0:
        raise StreamError("vp8_parse_dims", rc)
    return w.value, h.value


def entropy_decode16_into(data, header, seg, luma_mode, chroma_mode, segment_ids, bpred,
                          skipped, non_zero, levels) -> None:
    """Levels-mode entropy pass of one VP8 keyframe into caller arrays.

    header int32 [16] and seg int32 [4*8] receive the frame and segment
    headers; the per-MB mode arrays are uint8 (bpred [nmb*16]); levels is
    int16 [nmb*25*16], the raw quantizer levels (block 24 = Y2).  Every
    array must be a C-contiguous, zero-filled view: only nonzero values are
    written.  Raises StreamError on a stream the C++ pass rejects.
    """
    buf = np.frombuffer(bytes(data), np.uint8)
    rc = load().vp8_entropy_decode16(
        _p(buf, ctypes.c_uint8), len(buf),
        _p(_DEFAULT_PROBS, ctypes.c_uint8), _p(_UPDATE_PROBS, ctypes.c_uint8),
        _p(_BPRED_PROBS, ctypes.c_uint8), _p(_DC_Q, ctypes.c_int16), _p(_AC_Q, ctypes.c_int16),
        _p(header, ctypes.c_int32), _p(seg, ctypes.c_int32),
        _p(luma_mode, ctypes.c_uint8), _p(chroma_mode, ctypes.c_uint8),
        _p(segment_ids, ctypes.c_uint8), _p(bpred, ctypes.c_uint8),
        _p(skipped, ctypes.c_uint8), _p(non_zero, ctypes.c_uint8),
        _p(levels, ctypes.c_int16),
    )
    if rc != 0:
        raise StreamError("vp8_entropy_decode16", rc)


def yuv420_to_rgb_fancy(ybuf: np.ndarray, ubuf: np.ndarray, vbuf: np.ndarray,
                        width: int, height: int) -> np.ndarray:
    """Fancy-upsampled YUV420 planes -> RGB [height, width, 3] uint8 on the
    host (the same arithmetic as kernel K4)."""
    ybuf, ubuf, vbuf = (np.ascontiguousarray(p, np.uint8) for p in (ybuf, ubuf, vbuf))
    rgb = np.empty((height, width, 3), np.uint8)
    rc = load().yuv420_to_rgb_fancy(
        _p(ybuf, ctypes.c_uint8), ybuf.shape[1],
        _p(ubuf, ctypes.c_uint8), _p(vbuf, ctypes.c_uint8), ubuf.shape[1],
        width, height, _p(rgb, ctypes.c_uint8),
    )
    if rc != 0:
        raise ValueError(f"yuv420_to_rgb_fancy failed: {rc}")
    return rgb


def rgb_to_yuv420(rgb: np.ndarray):
    """BT.601 fixed-point RGB->YUV420 with 2x2 chroma averaging and
    edge-replicated padding to whole MBs: rgb [h, w, 3|4] uint8 ->
    (y [mbh*16, mbw*16], u, v [mbh*8, mbw*8]) uint8."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] not in (3, 4):
        raise ValueError(f"rgb must be [h, w, 3|4] uint8, got {rgb.shape}")
    h, w, ch = rgb.shape
    mbw, mbh = (w + 15) // 16, (h + 15) // 16
    y = np.empty((mbh * 16, mbw * 16), np.uint8)
    u = np.empty((mbh * 8, mbw * 8), np.uint8)
    v = np.empty((mbh * 8, mbw * 8), np.uint8)
    rc = load().rgb_to_yuv420(_p(rgb, ctypes.c_uint8), h, w, ch, _p(y, ctypes.c_uint8),
                              _p(u, ctypes.c_uint8), _p(v, ctypes.c_uint8))
    if rc != 0:
        raise ValueError(f"rgb_to_yuv420 failed: {rc}")
    return y, u, v


WIRE_CAP_MB_MAX = 512  # the C++ expansion's per-MB value buffer


def wire_expand_levels(bitmap: np.ndarray, vals4: np.ndarray, med_idx: np.ndarray,
                       med_val: np.ndarray, nmb: int, cap_mb: int = None) -> np.ndarray:
    """Dense int16 levels [nmb, 400] of one image's sparse wire (`ops/wire.py`):
    bitmap uint8 [nmb * 50] (np.packbits order), vals4 uint8 [nmb, cap_mb / 2]
    (two's-complement nibbles, the even rank low; cap_mb None: two per
    byte of vals4), med_idx uint8 / med_val int8 [nmb, med_cap] (rank and
    value of each |v| > 7, padding value 0).  Raises ValueError for a
    cap_mb that is odd or above WIRE_CAP_MB_MAX, for arrays that do not fit,
    and on the C++ codes: -1 an MB holds more nonzeros than cap_mb (the
    image needs its dense row), -3 a med entry past its MB's count."""
    bitmap = np.ascontiguousarray(bitmap, np.uint8)
    vals4 = np.ascontiguousarray(vals4, np.uint8)
    med_idx = np.ascontiguousarray(med_idx, np.uint8)
    med_val = np.ascontiguousarray(med_val, np.int8)
    if cap_mb is None:
        cap_mb = 2 * vals4.shape[1]
    if not 0 < cap_mb <= WIRE_CAP_MB_MAX or cap_mb % 2:
        raise ValueError(f"cap_mb must be even and in 2..{WIRE_CAP_MB_MAX}, got {cap_mb}")
    if (bitmap.size != nmb * 50 or vals4.shape != (nmb, cap_mb // 2)
            or med_idx.shape != med_val.shape or med_idx.shape[0] != nmb):
        raise ValueError(f"wire arrays {bitmap.shape} {vals4.shape} {med_idx.shape} "
                         f"{med_val.shape} do not fit {nmb} MBs")
    out = np.zeros((nmb, 400), np.int16)
    rc = load().wire_expand_levels(
        _p(bitmap, ctypes.c_uint8), _p(vals4, ctypes.c_uint8), _p(med_idx, ctypes.c_uint8),
        _p(med_val, ctypes.c_int8), nmb, cap_mb, med_val.shape[1], _p(out, ctypes.c_int16))
    if rc != 0:
        raise ValueError(f"wire_expand_levels failed: {rc}")
    return out


def vp8_token_stats(levels: np.ndarray, meta: np.ndarray):
    """Token statistics of [N, 16] zigzag level blocks with [N, 4] (plane,
    first, ctx, _) rows: (totals, ones) [4, 8, 3, 11] int64."""
    levels = np.ascontiguousarray(levels, np.int32)
    meta = np.ascontiguousarray(meta, np.int32)
    totals = np.zeros((4, 8, 3, 11), np.int64)
    ones = np.zeros((4, 8, 3, 11), np.int64)
    load().vp8_token_stats(_p(levels, ctypes.c_int32), _p(meta, ctypes.c_int32), len(levels),
                           _p(totals, ctypes.c_int64), _p(ones, ctypes.c_int64))
    return totals, ones


def vp8_token_encode(levels: np.ndarray, meta: np.ndarray, probs: np.ndarray) -> bytes:
    """One boolean-coded coefficient partition of [N, 16] level blocks with
    [N, 4] (plane, first, ctx, _) rows, under token probabilities [4, 8, 3, 11]."""
    levels = np.ascontiguousarray(levels, np.int32)
    meta = np.ascontiguousarray(meta, np.int32)
    probs = np.ascontiguousarray(probs, np.uint8)
    cap = max(levels.size * 8, 4096)
    out = np.zeros(cap, np.uint8)
    n = load().vp8_token_encode(_p(levels, ctypes.c_int32), _p(meta, ctypes.c_int32),
                                len(levels), _p(probs, ctypes.c_uint8), _p(out, ctypes.c_uint8), cap)
    if n < 0:
        raise ValueError("vp8_token_encode overflow")
    return out[:n].tobytes()


def vp8_mbheader_encode(enc, luma_mode, bpred, chroma_mode, skipped, mbw: int, skip_prob: int,
                        segment_ids, write_segments: bool, seg_tree_probs) -> bytes:
    """Continue the frame header's `BoolEncoder` `enc` with every MB header
    (with its segment id under `seg_tree_probs` when `write_segments`, the
    frame's update-map flag), flush, and return the first partition's bytes."""
    state = np.frombuffer(bytes(enc.out), np.uint8)
    nmb = len(luma_mode)
    cap = len(state) + nmb * 16 + 4096
    out = np.zeros(cap, np.uint8)
    luma_mode, bpred, chroma_mode, segment_ids = (
        np.ascontiguousarray(a, np.int32) for a in (luma_mode, bpred, chroma_mode, segment_ids))
    skipped = np.ascontiguousarray(skipped, np.uint8)
    seg_probs = np.ascontiguousarray(seg_tree_probs, np.uint8)
    state_p = state if len(state) else np.zeros(1, np.uint8)
    n = load().vp8_mbheader_encode(
        _p(state_p, ctypes.c_uint8), len(state), ctypes.c_uint32(enc.bottom),
        ctypes.c_uint32(enc.range), enc.bit_num,
        _p(luma_mode, ctypes.c_int32), _p(bpred, ctypes.c_int32),
        _p(chroma_mode, ctypes.c_int32), _p(segment_ids, ctypes.c_int32),
        _p(skipped, ctypes.c_uint8), nmb, mbw, skip_prob, int(bool(write_segments)),
        _p(seg_probs, ctypes.c_uint8),
        _p(_BPRED_PROBS, ctypes.c_uint8), _p(out, ctypes.c_uint8), cap,
    )
    if n < 0:
        raise ValueError(f"vp8_mbheader_encode failed: {n}")
    return out[:n].tobytes()


def vp8l_decode_entropy(data, width: int, height: int, implicit: bool = False):
    """The entropy pass of one VP8L stream, its inverse transforms not applied.

    Returns (buf [height, tw, 4] uint8, transforms): tw is the width the
    entropy-coded image has after the stream's transforms (a palette of <= 16
    colours packs it), and transforms lists (type, size_bits, table_size,
    data) in stream order: type 0 predictor, 1 colour, 2 subtract-green,
    3 colour indexing; data is the sub-image (bh * bw * 4 bytes) or the
    delta-decoded palette (table_size * 4 bytes) as uint8.  `implicit`: the
    stream has no header (an ALPH payload).  Raises StreamError with the C++
    error code on a stream it rejects.
    """
    src = np.frombuffer(bytes(data), np.uint8)
    out = np.zeros(height * width * 4, np.uint8)
    meta = np.zeros(1 + 4 * 4, np.int32)  # [n, (type, size_bits, table_size, len) x 4]
    # The largest sub-images: predictor and colour images at size_bits 2,
    # plus a 256-entry palette.
    tdata = np.zeros(2 * ((width + 3) // 4) * ((height + 3) // 4) * 4 + 1024, np.uint8)
    tw = load().vp8l_decode_entropy(
        _p(src, ctypes.c_uint8), len(src), width, height, int(bool(implicit)),
        _p(out, ctypes.c_uint8), _p(meta, ctypes.c_int32), _p(tdata, ctypes.c_uint8), len(tdata),
    )
    if tw <= 0:
        raise StreamError("vp8l_decode_entropy", tw)
    transforms, off = [], 0
    for i in range(int(meta[0])):
        ttype, size_bits, table_size, dlen = (int(v) for v in meta[1 + 4 * i: 5 + 4 * i])
        transforms.append((ttype, size_bits, table_size, tdata[off: off + dlen].copy()))
        off += dlen
    return out[: height * tw * 4].reshape(height, tw, 4), transforms


def vp8l_decode(data, width: int, height: int, implicit: bool = False) -> np.ndarray:
    """Full host decode of one VP8L stream, transforms included ->
    RGBA [height, width, 4] uint8.  Raises StreamError with the C++ error
    code on a stream it rejects."""
    src = np.frombuffer(bytes(data), np.uint8)
    out = np.empty((height, width, 4), np.uint8)
    rc = load().vp8l_decode(_p(src, ctypes.c_uint8), len(src), width, height,
                            int(bool(implicit)), _p(out, ctypes.c_uint8))
    if rc != 0:
        raise StreamError("vp8l_decode", rc)
    return out


def vp8l_lz77(packed: np.ndarray):
    """Greedy windowed LZ77 over packed ARGB pixels [n] -> (lens, dists) int64
    per token in stream order: lens 1 a literal (dist 0), lens >= 2 a copy
    of lens pixels from dists back."""
    px = np.ascontiguousarray(packed, np.uint32)
    n = len(px)
    out_len = np.zeros(n, np.int32)
    out_dist = np.zeros(n, np.int32)
    nt = load().vp8l_lz77(_p(px, ctypes.c_uint32), n, _p(out_len, ctypes.c_int32),
                          _p(out_dist, ctypes.c_int32), n, 1)
    if nt < 0:
        raise ValueError(f"vp8l_lz77 failed: {nt}")
    return out_len[:nt].astype(np.int64), out_dist[:nt].astype(np.int64)


def vp8l_huffman_lengths(hist: np.ndarray, offs: np.ndarray, limit: int = 15) -> np.ndarray:
    """Limited Huffman code lengths uint8 [K, A] of [K, A] histograms whose
    columns are alphabets side by side: alphabet s spans columns
    [offs[s], offs[s + 1]).  An alphabet with fewer than two symbols used
    gets all-zero lengths."""
    hist = np.ascontiguousarray(hist, np.int64)
    if hist.ndim == 1:
        hist = hist[None]
    K, A = hist.shape
    offs = np.ascontiguousarray(offs, np.int32)
    out = np.zeros((K, A), np.uint8)
    rc = load().vp8l_huffman_lengths(_p(hist, ctypes.c_int64), K, A, _p(offs, ctypes.c_int32),
                                     len(offs) - 1, limit, _p(out, ctypes.c_uint8))
    if rc != 0:
        raise ValueError(f"vp8l_huffman_lengths failed: {rc}")
    return out


def vp8l_cache_hits(packed: np.ndarray, bits: int):
    """Colour-cache hits of packed ARGB pixels [n] at `bits` (1..11): (hits
    bool, hash int64) per pixel; a pixel hits when the last earlier pixel
    of its hash bucket holds its value."""
    px = np.ascontiguousarray(packed, np.uint32)
    n = len(px)
    hits = np.zeros(n, np.uint8)
    hsh = np.zeros(n, np.int32)
    rc = load().vp8l_cache_hits(_p(px, ctypes.c_uint32), n, bits, _p(hits, ctypes.c_uint8),
                                _p(hsh, ctypes.c_int32))
    if rc != 0:
        raise ValueError(f"vp8l_cache_hits failed: {rc}")
    return hits.astype(bool), hsh.astype(np.int64)


def vp8l_pick_predictors(u: np.ndarray, w: int, h: int, size_bits: int, cost_lut: np.ndarray):
    """The best of the 14 VP8L predictors per tile of 2^size_bits pixels of
    u [h, w, 4] (subtract-green domain, 0..255) under the 129-entry cost
    table (1/32 bit): (modes [bh, bw] uint8, wrapped residual [h, w, 4] uint8)."""
    u8 = np.ascontiguousarray(u, np.uint8)
    bw = (w + (1 << size_bits) - 1) >> size_bits
    bh = (h + (1 << size_bits) - 1) >> size_bits
    modes = np.zeros((bh, bw), np.uint8)
    res = np.zeros((h, w, 4), np.uint8)
    lut = np.ascontiguousarray(cost_lut, np.uint8)
    rc = load().vp8l_pick_predictors(_p(u8, ctypes.c_uint8), w, h, size_bits,
                                     _p(lut, ctypes.c_uint8), _p(modes, ctypes.c_uint8),
                                     _p(res, ctypes.c_uint8))
    if rc != 0:
        raise ValueError(f"vp8l_pick_predictors failed: {rc}")
    return modes, res

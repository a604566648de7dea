"""Frozen copy of the plain code of `webp_tpu_torch/encode/vp8.py`, the
benchmark's reference; it imports nothing of the port.

The host finisher of the two-pass lossy encode: from one image's per-MB
decisions and levels and its adapted probabilities to its VP8 payload:
skip flags and token contexts, the skip probability, the frame header with
the segment header, the MB headers with the segment map and the
coefficient partitions (the Python coders of `coders.py`).
"""

from __future__ import annotations

import numpy as np

from ..common import vp8_tables as T
from .analysis import Segmentation, segments_off
from .boolenc import BoolEncoder
from .coders import mbheader_encode, token_encode
from .contexts import compute_contexts
from .quant import SegmentParams, compute_filter_level, quality_to_quant_index

PARTITIONS = (1, 2, 4, 8)
MAX_FIRST_PARTITION = 1 << 19  # the frame tag's 19-bit first-partition size


def skip_flags(arrays) -> np.ndarray:
    """[nmb] bool: the MB carries no nonzero level."""
    return ((arrays["y_levels"] == 0).all(axis=(1, 2))
            & (arrays["uv_levels"] == 0).all(axis=(1, 2))
            & (arrays["y2_levels"] == 0).all(axis=1))


def token_stream(arrays, ctx, skipped, mbw: int):
    """(levels [N, 16], meta [N, 4]) of the coded blocks in bitstream order;
    meta rows are (plane, first, ctx, MB row)."""
    nmb = len(skipped)
    has_y2 = ctx["has_y2"]
    all_levels = np.concatenate(
        [arrays["y2_levels"][:, None, :], arrays["y_levels"], arrays["uv_levels"]], axis=1,
    )  # [nmb, 25, 16]
    plane = np.zeros((nmb, 25), np.int32)
    plane[:, 0] = 1
    plane[:, 1:17] = np.where(has_y2, 0, 3)[:, None]
    plane[:, 17:] = 2
    first = np.zeros((nmb, 25), np.int32)
    first[:, 1:17] = np.where(has_y2, 1, 0)[:, None]
    ctxs = np.concatenate([ctx["y2_ctx"][:, None], ctx["y_ctx"], ctx["uv_ctx"]], axis=1)
    valid = np.ones((nmb, 25), bool)
    valid[:, 0] = has_y2
    valid &= ~skipped[:, None]

    sel = valid.reshape(-1)
    mby = np.repeat(np.arange(nmb, dtype=np.int32) // mbw, 25)
    levels = all_levels.reshape(-1, 16)[sel]
    meta = np.zeros((len(levels), 4), np.int32)
    meta[:, 0] = plane.reshape(-1)[sel]
    meta[:, 1] = first.reshape(-1)[sel]
    meta[:, 2] = ctxs.reshape(-1)[sel]
    meta[:, 3] = mby[sel]
    return levels, meta


def _frame_header(enc: BoolEncoder, quant_index: int, segs: Segmentation,
                  num_partitions: int, new_probs: np.ndarray, skip_prob: int) -> None:
    """Keyframe header fields up to the MB headers."""
    filter_level = compute_filter_level(quant_index)
    if segs.enabled:
        # Per-segment loop-filter strengths: segment 0's is the base level.
        seg_lf = [int(s.lf_level) for s in segs.segments]
        filter_level = seg_lf[0]
    enc.write_literal(1, 0)  # color space
    enc.write_literal(1, 0)  # pixel type (clamping)
    enc.write_flag(segs.enabled)
    if segs.enabled:
        enc.write_flag(segs.update_map)
        enc.write_flag(True)   # update segment feature data
        enc.write_flag(False)  # delta (not absolute) values
        for s in segs.segments:
            enc.write_optional_signed(7, int(s.quantizer_level))
        for lf in seg_lf:
            enc.write_optional_signed(6, lf - filter_level)
        if segs.update_map:
            for p in segs.tree_probs:
                enc.write_flag(p != 255)
                if p != 255:
                    enc.write_literal(8, p)
    enc.write_flag(False)    # filter type: normal
    enc.write_literal(6, filter_level)
    enc.write_literal(3, 0)  # sharpness
    enc.write_flag(False)    # no loop filter adjustments
    enc.write_literal(2, num_partitions.bit_length() - 1)
    enc.write_literal(7, quant_index)  # the frame's index; segments ride as deltas
    for _ in range(3):       # ydc, y2dc, y2ac deltas
        enc.write_flag(False)
    lead = segs.segments[0]
    enc.write_optional_signed(4, lead.uv_dc_delta)
    enc.write_optional_signed(4, lead.uv_ac_delta)
    enc.write_literal(1, 0)  # refresh entropy probs
    old, upd = T.COEFF_PROBS_DEFAULT, T.COEFF_UPDATE_PROBS
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    if new_probs[t, b, c, p] != old[t, b, c, p]:
                        enc.write_bool(1, int(upd[t, b, c, p]))
                        enc.write_literal(8, int(new_probs[t, b, c, p]))
                    else:
                        enc.write_bool(0, int(upd[t, b, c, p]))
    enc.write_literal(1, 1)  # mb_no_skip_coeff
    enc.write_literal(8, skip_prob)


def skip_probability(skipped: np.ndarray) -> int:
    """The header's probability that an MB is not skipped, from the skip flags."""
    total = len(skipped)
    non_skip = int(total - np.count_nonzero(skipped))
    return min(max((255 * non_skip + total // 2) // total, 1), 254)


def header_coder(probs, quality: int, num_partitions: int, segs: Segmentation,
                 skip_prob: int) -> BoolEncoder:
    """The frame header written up to the MB headers: the coder whose state
    the MB-header coders continue (`segs` None: segments off)."""
    qi = quality_to_quant_index(quality)
    if segs is None:
        segs = segments_off(0, SegmentParams(qi))
    enc = BoolEncoder()
    _frame_header(enc, qi, segs, num_partitions, probs, skip_prob)
    return enc


def payload(header: bytes, parts, width: int, height: int) -> bytes:
    """The VP8 payload: frame tag, start code and dimensions, the first
    partition (frame and MB headers), the sizes of all coefficient
    partitions but the last, and the partitions."""
    if len(header) >= MAX_FIRST_PARTITION:
        raise ValueError("partition 0 overflow (header > 512 KiB)")
    out = bytearray()
    tag = (len(header) << 5) | (1 << 4)  # show_frame, version 0, keyframe
    out += bytes([tag & 0xFF, (tag >> 8) & 0xFF, (tag >> 16) & 0xFF])
    out += b"\x9d\x01\x2a"
    out += bytes([width & 0xFF, (width >> 8) & 0x3F, height & 0xFF, (height >> 8) & 0x3F])
    out += header
    out += b"".join(len(pb).to_bytes(3, "little") for pb in parts[:-1])
    out += b"".join(parts)
    return bytes(out)


def check_partitions(num_partitions: int) -> None:
    if num_partitions not in PARTITIONS:
        raise ValueError(f"num_partitions must be one of {PARTITIONS}, got {num_partitions}")


def finish_frame(arrays, probs, quality: int, width: int, height: int,
                 num_partitions: int = 1, segs: Segmentation = None) -> bytes:
    """VP8 payload of one image from its analysis arrays (luma_mode,
    chroma_mode [nmb], bpred [nmb, 16], y_levels [nmb, 16, 16], y2_levels
    [nmb, 16], uv_levels [nmb, 8, 16]).  `probs` [4, 8, 3, 11] are the token
    probabilities adapted from pass 1 (two-pass flow), or None to adapt them
    here from these arrays' own token statistics; `segs` the image's
    segmentation (None: segments off)."""
    check_partitions(num_partitions)
    mbw, mbh = (width + 15) // 16, (height + 15) // 16
    if segs is None:
        segs = segments_off(mbw * mbh, SegmentParams(quality_to_quant_index(quality)))
    skipped = skip_flags(arrays)
    ctx = compute_contexts(arrays["luma_mode"], arrays["y2_levels"], arrays["y_levels"],
                           arrays["uv_levels"], mbw, mbh)
    levels, meta = token_stream(arrays, ctx, skipped, mbw)
    if probs is None:
        raise ValueError("the reference codes the two-pass flow: give the adapted probs")

    skip_prob = skip_probability(skipped)
    enc = header_coder(probs, quality, num_partitions, segs, skip_prob)
    header = mbheader_encode(enc, arrays["luma_mode"], arrays["bpred"],
                                        arrays["chroma_mode"], skipped, mbw, skip_prob,
                                        segs.segment_map, segs.enabled and segs.update_map,
                                        segs.tree_probs)

    # MB row r goes to coefficient partition r % num_partitions.
    parts = []
    for p in range(num_partitions):
        psel = (meta[:, 3] % num_partitions) == p
        parts.append(token_encode(levels[psel], meta[psel], probs))
    return payload(header, parts, width, height)

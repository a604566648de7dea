"""Frozen copy of the plain code of `webp_tpu_torch/encode/analysis.py`, the
benchmark's reference; it imports nothing of the port.

Segmentation of the lossy encode (host): per-image k-means over the
per-MB alphas that kernel K8 computes (`ops/analysis.py`), and the
per-segment quantizers, loop-filter strengths and segment-tree
probabilities the frame header carries.

A jax-free copy of `webp_tpu/encode/analysis.py` `assign_segments_kmeans`
(:152) and `compute_segment_quant` (:189), and of `webp_tpu/encode/vp8.py`
`setup_segments_from_alphas` (:1094) with its content-adaptive chroma-AC
delta on (the JAX package's `ADAPTIVE_UV_AC` default).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from .quant import SegmentParams, compute_filter_level

NUM_SEGMENTS = 4
MIN_MBS = 256  # segmentation runs on frames of at least this many MBs


class Segmentation(NamedTuple):
    """One image's segmentation: the header's flags, the per-MB segment ids
    [nmb] int32, the four segments' parameters and the tree probabilities."""

    enabled: bool
    update_map: bool
    segment_map: np.ndarray
    segments: List[SegmentParams]
    tree_probs: List[int]


def segments_off(nmb: int, seg: SegmentParams) -> Segmentation:
    return Segmentation(False, False, np.zeros(nmb, np.int32), [seg] * NUM_SEGMENTS,
                        [255, 255, 255])


def assign_segments_kmeans(histogram, num_segments: int = NUM_SEGMENTS):
    """1-D k-means over the alpha histogram (6 iterations, early stop):
    (centers [num_segments], alpha -> segment map [256], weighted mean)."""
    nz = np.flatnonzero(histogram)
    min_a, max_a = (int(nz[0]), int(nz[-1])) if len(nz) else (0, 255)
    range_a = max_a - min_a
    centers = np.array(
        [min_a + (1 + 2 * k) * range_a // (2 * num_segments) for k in range(num_segments)],
        np.int64,
    )
    amap = np.zeros(256, np.int64)
    weighted_avg, total_w = 128, 0
    for _ in range(6):
        accum = np.zeros(num_segments, np.int64)
        dist = np.zeros(num_segments, np.int64)
        cur = 0
        for a in range(min_a, max_a + 1):
            if histogram[a] > 0:
                while cur + 1 < num_segments and abs(a - centers[cur + 1]) < abs(a - centers[cur]):
                    cur += 1
                amap[a] = cur
                dist[cur] += a * histogram[a]
                accum[cur] += histogram[a]
        displaced = 0
        weighted_avg, total_w = 0, 0
        for n in range(num_segments):
            if accum[n] > 0:
                new_c = (dist[n] + accum[n] // 2) // accum[n]
                displaced += abs(centers[n] - new_c)
                centers[n] = new_c
                weighted_avg += new_c * accum[n]
                total_w += accum[n]
        if displaced < 5:
            break
    weighted_avg = (weighted_avg + total_w // 2) // total_w if total_w else 128
    return centers, amap, int(weighted_avg)


def compute_segment_quant(base_quant: int, segment_alpha: int, sns_strength: int = 50) -> int:
    """Power-law quantizer modulation (libwebp VP8SetSegmentParams): smooth
    segments (positive centred alpha) get a finer quantizer."""
    amp = 0.9 * sns_strength / 100.0 / 128.0
    expn = 1.0 - amp * segment_alpha
    if expn <= 0.0:
        return base_quant
    c_base = 1.0 - base_quant / 127.0
    c = c_base ** expn if c_base > 0 else 0.0
    return min(max(int(127.0 * (1.0 - c)), 0), 127)


def _proba(a: int, b: int) -> int:
    t = a + b
    return int((255 * a + t // 2) // t) if t else 255


def setup_segments_from_alphas(alphas, uv_alpha: int, base_qi: int) -> Segmentation:
    """K-means segments of one image from its per-MB alphas [nmb] and its
    mean chroma alpha, at the frame's quant index `base_qi`."""
    alphas = np.asarray(alphas, np.int64)
    centers, amap, mid = assign_segments_kmeans(np.bincount(alphas, minlength=256))
    lo, hi = int(centers.min()), int(centers.max())
    rng = max(hi - lo, 1)
    segment_map = amap[alphas].astype(np.int32)
    # Content-adaptive chroma-AC delta (libwebp dq_uv_ac): the centred
    # uv_alpha mapped onto [-4, 6], scaled by sns/100 (C truncation).
    d = int((uv_alpha - 64) * (6 - (-4)) / (100 - 30))
    uv_ac_delta = min(max(int(d * 50 / 100), -4), 6)
    segments = []
    for c in centers:
        t_alpha = min(max(255 * (int(c) - mid) // rng, -127), 127)
        sp = SegmentParams(base_qi, compute_segment_quant(base_qi, t_alpha) - base_qi,
                           uv_ac_delta=uv_ac_delta)
        # Busier segments (larger beta) are filtered less.
        beta = min(max(255 * (int(c) - lo) // rng, 0), 255)
        sp.lf_level = compute_filter_level(sp.quant_index, 0, 60, beta)
        segments.append(sp)
    counts = np.bincount(segment_map, minlength=NUM_SEGMENTS)
    tree_probs = [_proba(counts[0] + counts[1], counts[2] + counts[3]),
                  _proba(counts[0], counts[1]), _proba(counts[2], counts[3])]
    return Segmentation(True, any(p != 255 for p in tree_probs), segment_map, segments,
                        tree_probs)

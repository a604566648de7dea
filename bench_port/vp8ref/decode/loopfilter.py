"""Frozen copy of `webp_tpu/ops/loopfilter.py` (numpy), part of the
benchmark's reference decoder; `src/` paths name the Rust reference codec's
sources.

VP8 loop filters (RFC 6386 §15), vectorized across the lanes of an edge.

Each call filters one edge segment (16 luma rows / 8 chroma rows, or the
transposed column case) as a single numpy gather->compute->scatter over an
[N, 8] window centered on the edge. Semantics parity:
`src/decoder/loop_filter.rs` (scalar) — the reference's AVX2
path computes the same values 16 lanes at a time, exactly like this.

Window layout: columns 0..7 = p3 p2 p1 p0 | q0 q1 q2 q3 (edge between 3,4).
"""

from __future__ import annotations

import numpy as np


def _s(v):
    """u8 -> signed (-128..127) int32."""
    return v.astype(np.int32) - 128


def _c(v):
    return np.clip(v, -128, 127)


def _u(v):
    """signed -> u8 with clamp."""
    return (_c(v) + 128).astype(np.uint8)


def _simple_threshold(w, limit):
    d0 = np.abs(w[:, 3].astype(np.int32) - w[:, 4])
    d1 = np.abs(w[:, 2].astype(np.int32) - w[:, 5])
    return (d0 * 2 + d1 // 2) <= limit


def _should_filter(w, interior, edge_limit):
    ok = _simple_threshold(w, edge_limit)
    wi = w.astype(np.int32)
    for a, b in ((0, 1), (1, 2), (2, 3), (7, 6), (6, 5), (5, 4)):
        ok &= np.abs(wi[:, a] - wi[:, b]) <= interior
    return ok


def _hev(w, threshold):
    wi = w.astype(np.int32)
    return (np.abs(wi[:, 2] - wi[:, 3]) > threshold) | (np.abs(wi[:, 5] - wi[:, 4]) > threshold)


def _common_adjust(w, use_outer, mask):
    """The 4-tap adjust on p1 p0 q0 q1; returns the `a` rounding value."""
    p1, p0, q0, q1 = _s(w[:, 2]), _s(w[:, 3]), _s(w[:, 4]), _s(w[:, 5])
    outer = np.where(use_outer, _c(p1 - q1), 0)
    a = _c(outer + 3 * (q0 - p0))
    b = _c(a + 3) >> 3
    a4 = _c(a + 4) >> 3
    w[:, 4] = np.where(mask, _u(q0 - a4), w[:, 4])
    w[:, 3] = np.where(mask, _u(p0 + b), w[:, 3])
    return a4


def simple_filter(w, edge_limit):
    mask = _simple_threshold(w, edge_limit)
    _common_adjust(w, np.ones(len(w), bool), mask)
    return w


def subblock_filter(w, hev_t, interior, edge_limit):
    mask = _should_filter(w, interior, edge_limit)
    hv = _hev(w, hev_t)
    a = _common_adjust(w, hv, mask)
    a1 = (a + 1) >> 1
    outer_mask = mask & ~hv
    q1, p1 = _s(w[:, 5]), _s(w[:, 2])
    w[:, 5] = np.where(outer_mask, _u(q1 - a1), w[:, 5])
    w[:, 2] = np.where(outer_mask, _u(p1 + a1), w[:, 2])
    return w


def mb_filter(w, hev_t, interior, edge_limit):
    mask = _should_filter(w, interior, edge_limit)
    hv = _hev(w, hev_t)
    wide_mask = mask & ~hv

    p2, p1, p0 = _s(w[:, 1]), _s(w[:, 2]), _s(w[:, 3])
    q0, q1, q2 = _s(w[:, 4]), _s(w[:, 5]), _s(w[:, 6])
    wv = _c(_c(p1 - q1) + 3 * (q0 - p0))
    a0 = _c((27 * wv + 63) >> 7)
    a1 = _c((18 * wv + 63) >> 7)
    a2 = _c((9 * wv + 63) >> 7)
    w[:, 4] = np.where(wide_mask, _u(q0 - a0), w[:, 4])
    w[:, 3] = np.where(wide_mask, _u(p0 + a0), w[:, 3])
    w[:, 5] = np.where(wide_mask, _u(q1 - a1), w[:, 5])
    w[:, 2] = np.where(wide_mask, _u(p1 + a1), w[:, 2])
    w[:, 6] = np.where(wide_mask, _u(q2 - a2), w[:, 6])
    w[:, 1] = np.where(wide_mask, _u(p2 + a2), w[:, 1])

    # HEV lanes fall back to the 4-tap adjust with outer taps.
    _common_adjust(w, np.ones(len(w), bool), mask & hv)
    return w


# -- plane-level edge application ------------------------------------------

def filter_vertical_edge(plane, y0, n_rows, col, kind, hev_t=0, interior=0, edge_limit=0):
    """Filter the vertical edge at `col` for rows [y0, y0+n_rows)."""
    w = plane[y0 : y0 + n_rows, col - 4 : col + 4].copy()
    _dispatch(w, kind, hev_t, interior, edge_limit)
    plane[y0 : y0 + n_rows, col - 4 : col + 4] = w


def filter_horizontal_edge(plane, row, x0, n_cols, kind, hev_t=0, interior=0, edge_limit=0):
    """Filter the horizontal edge at `row` for columns [x0, x0+n_cols)."""
    w = plane[row - 4 : row + 4, x0 : x0 + n_cols].T.copy()
    _dispatch(w, kind, hev_t, interior, edge_limit)
    plane[row - 4 : row + 4, x0 : x0 + n_cols] = w.T


def _dispatch(w, kind, hev_t, interior, edge_limit):
    if kind == "simple":
        simple_filter(w, edge_limit)
    elif kind == "sub":
        subblock_filter(w, hev_t, interior, edge_limit)
    elif kind == "mb":
        mb_filter(w, hev_t, interior, edge_limit)
    else:
        raise ValueError(kind)

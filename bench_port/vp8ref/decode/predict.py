"""Frozen copy of `webp_tpu/ops/predict.py` (numpy), part of the
benchmark's reference decoder; `src/` paths name the Rust reference codec's
sources.

VP8 intra prediction: bordered-workspace predictors with exact RFC 6386
§12.2-12.3 semantics (parity: `src/common/prediction.rs`).

The workspace is a (1+size[+4]) bordered uint8 grid per macroblock: row 0 is
the top border (with 4 extra top-right pixels for luma), column 0 the left
border, cell (0,0) the corner. All math is on small numpy arrays; the batched
device path reuses these exact formulas inside the wavefront kernel.
"""

from __future__ import annotations

import numpy as np

# IntraMode numbering (B_* order from RFC 6386 §11.5, matches the bitstream).
B_DC, B_TM, B_VE, B_HE, B_LD, B_RD, B_VR, B_VL, B_HD, B_HU = range(10)
# LumaMode / ChromaMode numbering.
DC_PRED, V_PRED, H_PRED, TM_PRED, B_PRED = range(5)


def create_border_luma(mbx, mby, mbw, top, left):
    """Build the 17x21 luma workspace (stored as [17, 21] uint8)."""
    ws = np.zeros((17, 21), np.uint8)
    if mby == 0:
        ws[0, 1:] = 127
    else:
        ws[0, 1:17] = top[mbx * 16 : mbx * 16 + 16]
        if mbx == mbw - 1:
            ws[0, 17:21] = top[mbx * 16 + 15]
        else:
            ws[0, 17:21] = top[mbx * 16 + 16 : mbx * 16 + 20]
    # Replicate the 4 top-right pixels at rows 4/8/12 for I4 modes that read
    # "above-right" beyond the macroblock.
    for r in (4, 8, 12):
        ws[r, 17:21] = ws[0, 17:21]
    if mbx == 0:
        ws[1:17, 0] = 129
    else:
        ws[1:17, 0] = left[1:17]
    ws[0, 0] = 127 if mby == 0 else (129 if mbx == 0 else left[0])
    return ws


def create_border_chroma(mbx, mby, top, left):
    """Build the 9x9 chroma workspace."""
    ws = np.zeros((9, 9), np.uint8)
    if mby == 0:
        ws[0, 1:] = 127
    else:
        ws[0, 1:9] = top[mbx * 8 : mbx * 8 + 8]
    if mbx == 0:
        ws[1:9, 0] = 129
    else:
        ws[1:9, 0] = left[1:9]
    ws[0, 0] = 127 if mby == 0 else (129 if mbx == 0 else left[0])
    return ws


def add_residue(ws, residue, y0, x0):
    """Clamped add of a 4x4 int32 residual block into the workspace."""
    region = ws[y0 : y0 + 4, x0 : x0 + 4].astype(np.int32)
    ws[y0 : y0 + 4, x0 : x0 + 4] = np.clip(region + residue.reshape(4, 4), 0, 255).astype(np.uint8)


# -- whole-block predictors -------------------------------------------------

def predict_v(ws, size, x0=1, y0=1):
    ws[y0 : y0 + size, x0 : x0 + size] = ws[y0 - 1, x0 : x0 + size]


def predict_h(ws, size, x0=1, y0=1):
    ws[y0 : y0 + size, x0 : x0 + size] = ws[y0 : y0 + size, x0 - 1 : x0]


def predict_tm(ws, size, x0=1, y0=1):
    p = np.int32(ws[y0 - 1, x0 - 1])
    above = ws[y0 - 1, x0 : x0 + size].astype(np.int32)
    left = ws[y0 : y0 + size, x0 - 1].astype(np.int32)
    ws[y0 : y0 + size, x0 : x0 + size] = np.clip(
        left[:, None] + above[None, :] - p, 0, 255
    ).astype(np.uint8)


def predict_dc(ws, size, has_above, has_left):
    shf = 2 if size == 8 else 3
    total = 0
    if has_left:
        total += int(ws[1 : 1 + size, 0].astype(np.uint32).sum())
        shf += 1
    if has_above:
        total += int(ws[0, 1 : 1 + size].astype(np.uint32).sum())
        shf += 1
    dc = 128 if not (has_above or has_left) else (total + (1 << (shf - 1))) >> shf
    ws[1 : 1 + size, 1 : 1 + size] = dc


# -- 4x4 B-mode predictors --------------------------------------------------

def _avg3(a, b, c):
    return (int(a) + 2 * int(b) + int(c) + 2) >> 2


def _avg2(a, b):
    return (int(a) + int(b) + 1) >> 1


def _edges(ws, x0, y0):
    """e0..e8: left pixels bottom-up, corner, then top pixels left-to-right."""
    return (
        ws[y0 + 3, x0 - 1],
        ws[y0 + 2, x0 - 1],
        ws[y0 + 1, x0 - 1],
        ws[y0, x0 - 1],
        ws[y0 - 1, x0 - 1],
        ws[y0 - 1, x0],
        ws[y0 - 1, x0 + 1],
        ws[y0 - 1, x0 + 2],
        ws[y0 - 1, x0 + 3],
    )


def predict_b(ws, mode, x0, y0):
    if mode == B_TM:
        predict_tm(ws, 4, x0, y0)
        return
    if mode == B_DC:
        v = 4
        v += int(ws[y0 - 1, x0 : x0 + 4].astype(np.uint32).sum())
        v += int(ws[y0 : y0 + 4, x0 - 1].astype(np.uint32).sum())
        ws[y0 : y0 + 4, x0 : x0 + 4] = v >> 3
        return
    out = ws[y0 : y0 + 4, x0 : x0 + 4]
    if mode == B_VE:
        p = ws[y0 - 1, x0 - 1]
        a = ws[y0 - 1, x0 : x0 + 5]
        row = [_avg3(p, a[0], a[1]), _avg3(a[0], a[1], a[2]), _avg3(a[1], a[2], a[3]), _avg3(a[2], a[3], a[4])]
        out[:, :] = np.array(row, np.uint8)
    elif mode == B_HE:
        p = ws[y0 - 1, x0 - 1]
        l0, l1, l2, l3 = ws[y0 : y0 + 4, x0 - 1]
        col = [_avg3(p, l0, l1), _avg3(l0, l1, l2), _avg3(l1, l2, l3), _avg3(l2, l3, l3)]
        out[:, :] = np.array(col, np.uint8)[:, None]
    elif mode == B_LD:
        a = ws[y0 - 1, x0 : x0 + 8]
        avgs = [_avg3(a[i], a[i + 1], a[min(i + 2, 7)]) for i in range(7)]
        for r in range(4):
            out[r] = avgs[r : r + 4]
    elif mode == B_RD:
        e = _edges(ws, x0, y0)
        avgs = [_avg3(e[i], e[i + 1], e[i + 2]) for i in range(7)]
        for r in range(4):
            out[r] = avgs[3 - r : 7 - r]
    elif mode == B_VR:
        e = _edges(ws, x0, y0)
        out[3, 0] = _avg3(e[1], e[2], e[3])
        out[2, 0] = _avg3(e[2], e[3], e[4])
        out[3, 1] = out[1, 0] = _avg3(e[3], e[4], e[5])
        out[2, 1] = out[0, 0] = _avg2(e[4], e[5])
        out[3, 2] = out[1, 1] = _avg3(e[4], e[5], e[6])
        out[2, 2] = out[0, 1] = _avg2(e[5], e[6])
        out[3, 3] = out[1, 2] = _avg3(e[5], e[6], e[7])
        out[2, 3] = out[0, 2] = _avg2(e[6], e[7])
        out[1, 3] = _avg3(e[6], e[7], e[8])
        out[0, 3] = _avg2(e[7], e[8])
    elif mode == B_VL:
        a = ws[y0 - 1, x0 : x0 + 8]
        out[0, 0] = _avg2(a[0], a[1])
        out[1, 0] = _avg3(a[0], a[1], a[2])
        out[2, 0] = out[0, 1] = _avg2(a[1], a[2])
        out[1, 1] = out[3, 0] = _avg3(a[1], a[2], a[3])
        out[2, 1] = out[0, 2] = _avg2(a[2], a[3])
        out[3, 1] = out[1, 2] = _avg3(a[2], a[3], a[4])
        out[2, 2] = out[0, 3] = _avg2(a[3], a[4])
        out[3, 2] = out[1, 3] = _avg3(a[3], a[4], a[5])
        out[2, 3] = _avg3(a[4], a[5], a[6])
        out[3, 3] = _avg3(a[5], a[6], a[7])
    elif mode == B_HD:
        e = _edges(ws, x0, y0)
        out[3, 0] = _avg2(e[0], e[1])
        out[3, 1] = _avg3(e[0], e[1], e[2])
        out[2, 0] = out[3, 2] = _avg2(e[1], e[2])
        out[2, 1] = out[3, 3] = _avg3(e[1], e[2], e[3])
        out[2, 2] = out[1, 0] = _avg2(e[2], e[3])
        out[2, 3] = out[1, 1] = _avg3(e[2], e[3], e[4])
        out[1, 2] = out[0, 0] = _avg2(e[3], e[4])
        out[1, 3] = out[0, 1] = _avg3(e[3], e[4], e[5])
        out[0, 2] = _avg3(e[4], e[5], e[6])
        out[0, 3] = _avg3(e[5], e[6], e[7])
    elif mode == B_HU:
        l0, l1, l2, l3 = ws[y0 : y0 + 4, x0 - 1]
        out[0, 0] = _avg2(l0, l1)
        out[0, 1] = _avg3(l0, l1, l2)
        out[0, 2] = out[1, 0] = _avg2(l1, l2)
        out[0, 3] = out[1, 1] = _avg3(l1, l2, l3)
        out[1, 2] = out[2, 0] = _avg2(l2, l3)
        out[1, 3] = out[2, 1] = _avg3(l2, l3, l3)
        out[2, 2] = out[2, 3] = l3
        out[3, :] = l3
    else:
        raise ValueError(f"bad B mode {mode}")

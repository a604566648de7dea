"""Frozen copy of the plain code of `webp_tpu_torch/ops/wavefront.py`, the
benchmark's reference; it imports nothing of the port.

The ten B-mode (4x4) intra predictors of bordered workspaces, as
`webp_tpu/ops/predict.py` forms them; the encode's K5 reads them.
"""

from __future__ import annotations

import torch



def _avg2(a, b):
    return (a + b + 1) >> 1


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def predict_b_all(e: torch.Tensor) -> torch.Tensor:
    """All ten 4x4 B-mode predictions (RFC 6386 12.3, ops/predict.py).

    e [..., 13] int32 = (L3, L2, L1, L0, top-left, A0..A7) -> [..., 10, 16]
    in mode order B_DC, B_TM, B_VE, B_HE, B_LD, B_RD, B_VR, B_VL, B_HD, B_HU.
    """
    E = [e[..., i] for i in range(13)]
    L = [E[3], E[2], E[1], E[0]]
    P = E[4]
    A = E[5:13]
    dc = (4 + A[0] + A[1] + A[2] + A[3] + L[0] + L[1] + L[2] + L[3]) >> 3
    tm = [(L[r] + A[c] - P).clamp(0, 255) for r in range(4) for c in range(4)]
    ve = [_avg3(P, A[0], A[1]), _avg3(A[0], A[1], A[2]),
          _avg3(A[1], A[2], A[3]), _avg3(A[2], A[3], A[4])]
    he = [_avg3(P, L[0], L[1]), _avg3(L[0], L[1], L[2]),
          _avg3(L[1], L[2], L[3]), _avg3(L[2], L[3], L[3])]
    ld = [_avg3(A[i], A[i + 1], A[min(i + 2, 7)]) for i in range(7)]
    rd = [_avg3(E[i], E[i + 1], E[i + 2]) for i in range(7)]

    vr = [None] * 16
    vr[12] = _avg3(E[1], E[2], E[3])
    vr[8] = _avg3(E[2], E[3], E[4])
    vr[13] = vr[4] = _avg3(E[3], E[4], E[5])
    vr[9] = vr[0] = _avg2(E[4], E[5])
    vr[14] = vr[5] = _avg3(E[4], E[5], E[6])
    vr[10] = vr[1] = _avg2(E[5], E[6])
    vr[15] = vr[6] = _avg3(E[5], E[6], E[7])
    vr[11] = vr[2] = _avg2(E[6], E[7])
    vr[7] = _avg3(E[6], E[7], E[8])
    vr[3] = _avg2(E[7], E[8])

    vl = [None] * 16
    vl[0] = _avg2(A[0], A[1])
    vl[4] = _avg3(A[0], A[1], A[2])
    vl[8] = vl[1] = _avg2(A[1], A[2])
    vl[5] = vl[12] = _avg3(A[1], A[2], A[3])
    vl[9] = vl[2] = _avg2(A[2], A[3])
    vl[13] = vl[6] = _avg3(A[2], A[3], A[4])
    vl[10] = vl[3] = _avg2(A[3], A[4])
    vl[14] = vl[7] = _avg3(A[3], A[4], A[5])
    vl[11] = _avg3(A[4], A[5], A[6])
    vl[15] = _avg3(A[5], A[6], A[7])

    hd = [None] * 16
    hd[12] = _avg2(E[0], E[1])
    hd[13] = _avg3(E[0], E[1], E[2])
    hd[8] = hd[14] = _avg2(E[1], E[2])
    hd[9] = hd[15] = _avg3(E[1], E[2], E[3])
    hd[10] = hd[4] = _avg2(E[2], E[3])
    hd[11] = hd[5] = _avg3(E[2], E[3], E[4])
    hd[6] = hd[0] = _avg2(E[3], E[4])
    hd[7] = hd[1] = _avg3(E[3], E[4], E[5])
    hd[2] = _avg3(E[4], E[5], E[6])
    hd[3] = _avg3(E[5], E[6], E[7])

    hu = [None] * 16
    hu[0] = _avg2(L[0], L[1])
    hu[1] = _avg3(L[0], L[1], L[2])
    hu[2] = hu[4] = _avg2(L[1], L[2])
    hu[3] = hu[5] = _avg3(L[1], L[2], L[3])
    hu[6] = hu[8] = _avg2(L[2], L[3])
    hu[7] = hu[9] = _avg3(L[2], L[3], L[3])
    hu[10] = hu[11] = hu[12] = hu[13] = hu[14] = hu[15] = L[3]

    modes = [
        [dc] * 16, tm,
        [ve[c] for r in range(4) for c in range(4)],
        [he[r] for r in range(4) for c in range(4)],
        [ld[r + c] for r in range(4) for c in range(4)],
        [rd[3 - r + c] for r in range(4) for c in range(4)],
        vr, vl, hd, hu,
    ]
    return torch.stack([torch.stack(m, dim=-1) for m in modes], dim=-2)

"""Seeded pass-2 arrays that drive every branch of the encode wire, jax-free
(`tests/test_torch_wire.py`, `tests/test_torch_cuda.py`, `chip_smoke.py`).

`wire_arrays(B, nmb, seed)` returns K5-shaped numpy arrays (int16 levels,
uint8 modes and B modes) and the flags [B, 2] each image's wire row must
carry.  Image b takes case b % 5:

0. plain: sparse levels, |level| > 127 escapes in a few MBs and the last;
1. an MB of 300 nonzeros: more than CAP_MB (flag 0, sp_over);
2. an MB of 40 levels with 7 < |v| < 128: more than MED_CAP (flag 0);
3. an MB of 5 escapes: more than N_ESC, the prepack's overflow (flag 1);
4. four escapes in every MB: more than ESC_IMG when 4 * nmb > 512 (flag 1),
   else a plain image.

Below 8 MBs the arrays are those of 8 MBs with each image's case MB first
(the MB of case 1, 2 or 3, else the last MB, which holds an escape), cut to
nmb: every flag of cases 1-3 still holds.
"""

from __future__ import annotations

import numpy as np

BIG = np.array([128, -128, 129, -300, 900, -2048, 32767, -32768])


def wire_arrays(B: int, nmb: int, seed: int):
    """(arrays dict of numpy [B, nmb, ...], levels int32 [B, nmb, 400],
    expected wire flags uint8 [B, 2])."""
    if nmb < 1:
        raise ValueError(f"nmb must be at least 1, got {nmb}")
    if nmb < 8:
        arrays, lv, flags = wire_arrays(B, 8, seed)
        first = [{1: 2, 2: 3, 3: 4}.get(b % 5, 7) for b in range(B)]
        order = np.array([[f] + [m for m in range(8) if m != f] for f in first])[:, :nmb]
        rows = np.arange(B)[:, None]
        return {k: a[rows, order] for k, a in arrays.items()}, lv[rows, order], flags
    rng = np.random.RandomState(seed)
    lv = (rng.randint(-3, 4, (B, nmb, 400)) * (rng.rand(B, nmb, 400) < 0.2)).astype(np.int32)
    flags = np.zeros((B, 2), np.uint8)

    def put(b, m, n, values):
        lv[b, m, rng.choice(400, n, replace=False)] = rng.choice(values, n)

    for b in range(B):
        case = b % 5
        for m in list(rng.choice(nmb, 3, replace=False)) + [nmb - 1]:
            lv[b, m, rng.randint(400)] = rng.choice(BIG)
        if case == 1:
            lv[b, 2] = 0
            put(b, 2, 300, [-2, -1, 1, 2])
            flags[b, 0] = 1
        elif case == 2:
            lv[b, 3] = 0
            put(b, 3, 40, [-100, -9, 8, 50, 127])
            flags[b, 0] = 1
        elif case == 3:
            lv[b, 4] = 0
            put(b, 4, 5, BIG)
            flags[b, 1] = 1
        elif case == 4:
            for m in range(nmb):
                lv[b, m] = np.clip(lv[b, m], -127, 127)
                put(b, m, 4, BIG)
            flags[b, 1] = int(4 * nmb > 512)
    arrays = {
        "y_levels": lv[..., :256].reshape(B, nmb, 16, 16).astype(np.int16),
        "uv_levels": lv[..., 256:384].reshape(B, nmb, 8, 16).astype(np.int16),
        "y2_levels": lv[..., 384:].astype(np.int16),
        "bpred": rng.randint(0, 10, (B, nmb, 16)).astype(np.uint8),
        "luma_mode": rng.randint(0, 5, (B, nmb)).astype(np.uint8),
        "chroma_mode": rng.randint(0, 4, (B, nmb)).astype(np.uint8),
    }
    return arrays, lv, flags

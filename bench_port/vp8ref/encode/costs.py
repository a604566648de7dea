"""Frozen copy of the plain code of `webp_tpu_torch/encode/costs.py`, the
benchmark's reference; it imports nothing of the port.

Probability-dependent level costs and token-statistics adaptation (host, numpy).

The parts of `webp_tpu/encode/costs.py` the batched encode needs: the
static level-code masks, `LevelCosts` (the cost tables of one probability
set) and `ProbaStats.updated_probs` (two-pass probability adaptation from
(total, ones) token counts).  Token counts themselves come from kernel K6
(`ops/token_stats.py`) or the host C++ `vp8_token_stats`.
"""

from __future__ import annotations

import numpy as np

from ..common import vp8_tables as T
from . import tables as ET

NUM_TYPES, NUM_BANDS, NUM_CTX = 4, 8, 3
MAX_VARIABLE_LEVEL = 67

ENT = ET.VP8_ENTROPY_COST.astype(np.int64)
BANDS = np.array(ET.VP8_ENC_BANDS[:16], np.int64)


def _build_level_code_masks():
    """cost(v >= 1) = sum_i A1[v-1, i] * bitcost(1, p[i+2]) + A0[v-1, i] *
    bitcost(0, p[i+2]), the 0/1 masks read off VP8_LEVEL_CODES' (pattern,
    bits) pairs."""
    a1 = np.zeros((MAX_VARIABLE_LEVEL, 9), np.int64)
    a0 = np.zeros((MAX_VARIABLE_LEVEL, 9), np.int64)
    for idx in range(MAX_VARIABLE_LEVEL):
        pattern = int(ET.VP8_LEVEL_CODES[idx, 0])
        bits = int(ET.VP8_LEVEL_CODES[idx, 1])
        i = 0
        while pattern:
            if pattern & 1:
                (a1 if bits & 1 else a0)[idx, i] = 1
            bits >>= 1
            pattern >>= 1
            i += 1
    return a1, a0


LC_A1, LC_A0 = _build_level_code_masks()


class LevelCosts:
    """Cost tables of one token probability set [4, 8, 3, 11]."""

    def __init__(self, probs: np.ndarray):
        p = probs.astype(np.int64)
        e1 = ENT[255 - p]  # cost of bit=1 per node
        e0 = ENT[p]        # cost of bit=0 per node
        cost0 = np.zeros((NUM_TYPES, NUM_BANDS, NUM_CTX), np.int64)
        cost0[:, :, 1:] = e1[:, :, 1:, 0]
        lc = np.zeros((NUM_TYPES, NUM_BANDS, NUM_CTX, MAX_VARIABLE_LEVEL + 1), np.int64)
        lc[..., 0] = e0[..., 1] + cost0
        var = np.einsum("vi,tbci->tbcv", LC_A1, e1[..., 2:]) + np.einsum(
            "vi,tbci->tbcv", LC_A0, e0[..., 2:]
        )
        lc[..., 1:] = (e1[..., 1] + cost0)[..., None] + var
        self.pos_cost = lc[:, BANDS]               # [4, 16, 3, 68]
        self.eob_cost = e0[..., 0][:, BANDS]      # [4, 16, 3]
        self.init_cost = e1[..., 0][:, BANDS]     # [4, 16, 3]


class ProbaStats:
    """Token statistics: (total, ones) counts per [type][band][ctx][node]."""

    def __init__(self, total, ones):
        self.total = np.asarray(total, np.int64)
        self.ones = np.asarray(ones, np.int64)

    def updated_probs(self, old_probs: np.ndarray) -> np.ndarray:
        """Choose per-node new probabilities when they pay for themselves."""
        total, nb = self.total, self.ones
        new_p = np.where(total > 0, 255 - (nb * 255) // np.maximum(total, 1), 255)
        old = old_probs.astype(np.int64)
        upd = T.COEFF_UPDATE_PROBS.astype(np.int64)

        def branch_cost(probs):
            return nb * ENT[255 - probs] + (total - nb) * ENT[probs]

        old_cost = branch_cost(old) + ENT[upd]
        new_cost = branch_cost(new_p) + ENT[255 - upd] + 8 * 256
        use_new = (total > 0) & (old_cost > new_cost)
        return np.where(use_new, new_p, old).astype(np.uint8)

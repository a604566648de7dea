"""Parameters of the encode kernels: the int32 RD score, the quantizer and
lambda set of a segment, and the per-image cost tables.

Counterparts of `webp_tpu/ops/encode_wavefront.py` `_rd_score32` (:23),
`BIG`, `ZZ`/`IZZ`, `EncParams` (:92) and `EncTables` (:44), as torch
tensors on an explicit device.  Both are built from numpy: `EncParams.
from_segment(seg)` from a host `SegmentParams`, `EncTables.from_probs(probs)`
from token probabilities, so that a test can hand the JAX package and the
port the same parameters.  On the card, kernel K7 (`ops/enc_tables.py`)
builds the tables from probabilities instead.
"""

from __future__ import annotations

import numpy as np
import torch

from ..encode import tables as ET
from ..encode.costs import LevelCosts

BIG = 1 << 30  # score of a disallowed mode
ZZ = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15])
IZZ = np.argsort(ZZ)
# pos_cost[..., v] is constant within each of the 11 token classes of
# min(v, 67); these are the classes' representative levels.
CLS_REPS = np.array([0, 1, 2, 3, 4, 5, 7, 11, 19, 35, 67])


def rd_score32(rate, disto, lam: int):
    """floor(rate * lam / 256) + disto on int32, by a hi/lo split of rate.

    Saturating, exactly as the JAX kernel: hi = min(rate >> 8, 2^30 // lam),
    so a huge rate scores about 2^30 instead of overflowing.
    """
    hi = (rate >> 8).clamp_max((1 << 30) // max(lam, 1))
    return hi * lam + (((rate & 255) * lam) >> 8) + disto


# Fixed tables the kernels read beside the per-image costs, in one int32
# vector: level fixed costs [2048], I4 mode costs [10, 10, 10], I16 and UV
# mode costs [4] each, TDisto luma weights [16].
_CONSTS = (
    ("fixed", np.asarray(ET.VP8_LEVEL_FIXED_COSTS, np.int32)),
    ("fixed_i4", np.asarray(ET.VP8_FIXED_COSTS_I4, np.int32).reshape(10, 10, 10)),
    ("fixed_i16", np.asarray(ET.FIXED_COSTS_I16, np.int32)),
    ("fixed_uv", np.asarray(ET.FIXED_COSTS_UV, np.int32)),
    ("weight_y", np.asarray(ET.VP8_WEIGHT_Y, np.int32)),
)
CONSTS_NP = np.concatenate([a.reshape(-1) for _, a in _CONSTS])


class EncParams:
    """Quantizer vectors (zigzag order: DC, then 15 AC) and RD lambdas of one
    segment: *_iq/*_bias/*_q int32 [16] for y1, y2 and uv; lambda_* ints."""

    VECS = ("y1_iq", "y1_bias", "y1_q", "y2_iq", "y2_bias", "y2_q", "uv_iq", "uv_bias", "uv_q")
    LAMS = ("lambda_i16", "lambda_i4", "lambda_uv", "lambda_mode", "tlambda")

    @classmethod
    def from_segment(cls, seg, device="cpu") -> "EncParams":
        p = cls()
        for name in cls.VECS:
            m, attr = name.split("_")
            v = np.empty(16, np.int32)
            v[:] = getattr(getattr(seg, m), attr)[1]
            v[0] = getattr(getattr(seg, m), attr)[0]
            setattr(p, name, torch.from_numpy(v).to(device))
        for name in cls.LAMS:
            setattr(p, name, int(getattr(seg, name)))
        return p

    def packed(self, device) -> torch.Tensor:
        """The kernel's view: int32 [9 * 16 + 5] (the vectors, then the lambdas)."""
        vecs = torch.cat([getattr(self, n).to(device="cpu", dtype=torch.int32) for n in self.VECS])
        lams = torch.tensor([getattr(self, n) for n in self.LAMS], dtype=torch.int32)
        return torch.cat([vecs, lams]).to(device)


class EncTables:
    """Per-image rate tables, int32 with a leading image axis:
    pos_cost [B, 4, 16, 3, 68] (token-tree cost per type, position, context
    and min(level, 67)), cls_cost [B, 4, 16, 3, 11] (the same at each token
    class), eob_cost / init_cost [B, 4, 16, 3] (the EOB bit at 0 and 1)."""

    FIELDS = ("pos_cost", "cls_cost", "eob_cost", "init_cost")

    def __init__(self, pos_cost, cls_cost, eob_cost, init_cost):
        self.pos_cost, self.cls_cost = pos_cost, cls_cost
        self.eob_cost, self.init_cost = eob_cost, init_cost

    @property
    def batch(self) -> int:
        return self.cls_cost.shape[0]

    @classmethod
    def from_probs(cls, probs: np.ndarray, device="cpu") -> "EncTables":
        """probs uint8 [4, 8, 3, 11] (one table) or [B, 4, 8, 3, 11], on the host."""
        probs = np.asarray(probs)
        if probs.ndim == 4:
            probs = probs[None]
        lcs = [LevelCosts(p) for p in probs]

        def field(get):
            a = np.ascontiguousarray(np.stack([get(lc) for lc in lcs]), np.int32)
            return torch.from_numpy(a).to(device)

        return cls(field(lambda lc: lc.pos_cost), field(lambda lc: lc.pos_cost[..., CLS_REPS]),
                   field(lambda lc: lc.eob_cost), field(lambda lc: lc.init_cost))

    def expand(self, batch: int) -> "EncTables":
        """A one-image table set seen as `batch` images (no copy)."""
        if self.batch == batch:
            return self
        if self.batch != 1:
            raise ValueError(f"tables for {self.batch} images, batch {batch}")
        return EncTables(*(getattr(self, f).expand(batch, *getattr(self, f).shape[1:])
                           for f in self.FIELDS))

"""Frozen copy of the plain code of `webp_tpu_torch/ops/enc_params.py`, the
benchmark's reference; it imports nothing of the port.

Parameters of the encode kernels: the int32 RD score, the quantizer and
lambda set of a segment, and the per-image cost tables.

Counterparts of `webp_tpu/ops/encode_wavefront.py` `_rd_score32` (:23),
`BIG`, `ZZ`/`IZZ`, `EncParams` (:92), `EncParamsSegs` (:153) and
`EncTables` (:44), as torch tensors on an explicit device.  Both are built
from numpy: `EncParams.from_segments(lists)` from host `SegmentParams` (four
per image), `EncTables.from_probs(probs)` from token probabilities, so that a
test can hand the JAX package and the port the same parameters.  On the
card, kernel K7 (`ops/enc_tables.py`) builds the tables from probabilities
instead.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _consts
from ..common import vp8_tables as T
from ..encode import tables as ET
from ..encode.costs import LevelCosts

BIG = 1 << 30  # score of a disallowed mode
ZZ = np.array([0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15])
IZZ = np.argsort(ZZ)
# pos_cost[..., v] is constant within each of the 11 token classes of
# min(v, 67); these are the classes' representative levels.
CLS_REPS = np.array([0, 1, 2, 3, 4, 5, 7, 11, 19, 35, 67])


def rd_score32(rate, disto, lam):
    """floor(rate * lam / 256) + disto on int32, by a hi/lo split of rate;
    `lam` int32 broadcastable to `rate` (per lane).

    Saturating, exactly as the JAX kernel: hi = min(rate >> 8, 2^30 // lam),
    so a huge rate scores about 2^30 instead of overflowing.
    """
    hi = torch.minimum(rate >> 8, (1 << 30) // lam.clamp_min(1))
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
    """Quantizer vectors (zigzag order: DC, then 15 AC) and RD and trellis
    lambdas of the four segments of each image: vectors int32 [B, 4, 16],
    lambdas int32 [B, 4].  B is 1 for one parameter set shared by a batch.
    Segments off is the segment-0 set of every image with segment ids 0."""

    VECS = ("y1_iq", "y1_bias", "y1_q", "y2_iq", "y2_bias", "y2_q", "uv_iq", "uv_bias", "uv_q",
            "y1_sharpen")
    LAMS = ("lambda_i16", "lambda_i4", "lambda_uv", "lambda_mode", "tlambda",
            "lambda_trellis_i16", "lambda_trellis_i4")
    SIZE = 16 * len(VECS) + len(LAMS)  # int32 per segment in `packed`

    @classmethod
    def from_segment(cls, seg, device="cpu") -> "EncParams":
        """One segment's parameters, shared by every image and MB."""
        return cls.from_segments([[seg] * 4], device)

    @classmethod
    def from_segments(cls, segments_lists, device="cpu") -> "EncParams":
        """Per image, a list of four `SegmentParams`; the fields are views of
        one upload (a copy to the device)."""
        def vec(seg, name):
            if name == "y1_sharpen":
                return np.asarray(seg.y1.sharpen)[ZZ]
            m, attr = name.split("_")
            v = np.empty(16, np.int64)
            v[:] = getattr(getattr(seg, m), attr)[1]
            v[0] = getattr(getattr(seg, m), attr)[0]
            return v

        fields = [np.array([[vec(s, name) for s in segs] for segs in segments_lists], np.int32)
                  for name in cls.VECS]
        fields += [np.array([[int(getattr(s, name)) for s in segs] for segs in segments_lists],
                            np.int32) for name in cls.LAMS]
        flat = _consts.upload(np.concatenate([a.reshape(-1) for a in fields]), device)
        p, at = cls(), 0
        for name, a in zip(cls.VECS + cls.LAMS, fields):
            setattr(p, name, flat[at:at + a.size].view(a.shape))
            at += a.size
        return p

    @property
    def batch(self) -> int:
        return self.y1_q.shape[0]

    def rows(self, start: int, stop: int) -> "EncParams":
        """Images start..stop-1 of a per-image instance (views, no copy):
        one rank's shard of a batched instance."""
        if not 0 <= start < stop <= self.batch:
            raise ValueError(f"rows {start}:{stop} of parameters for {self.batch} images")
        p = EncParams()
        for name in self.VECS + self.LAMS:
            setattr(p, name, getattr(self, name)[start:stop])
        return p

    def packed(self, device) -> torch.Tensor:
        """The kernel's view: int32 [B, 4, SIZE] (per segment the vectors,
        then the lambdas)."""
        parts = [getattr(self, n) for n in self.VECS] + [getattr(self, n)[..., None]
                                                         for n in self.LAMS]
        return torch.cat([t.to(device=device, dtype=torch.int32) for t in parts], -1).contiguous()

    def lanes(self, sid) -> "EncParams":
        """Per-lane parameters of MBs with segment ids `sid` [n, B]: vectors
        [n, B, 16], lambdas [n, B]."""
        n, B = sid.shape
        idx = sid.long()
        p = EncParams()
        for name in self.VECS + self.LAMS:
            t = getattr(self, name)                        # [B or 1, 4(, 16)]
            t = t.expand(B, *t.shape[1:])[None].expand(n, B, *t.shape[1:])
            sel = idx.reshape(n, B, 1, *([1] * (t.ndim - 3))).expand(n, B, 1, *t.shape[3:])
            setattr(p, name, torch.gather(t, 2, sel)[:, :, 0])
        return p


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

    @classmethod
    def default(cls, device) -> "EncTables":
        """The one table set of the default token probabilities on `device`,
        made once per device (`_consts.device_constant`)."""
        return cls(*(_consts.device_constant(f"default_{f}", a, device).view(a.shape)
                     for f, a in zip(cls.FIELDS, _default_fields())))

    def rows(self, start: int, stop: int) -> "EncTables":
        """Images start..stop-1 of per-image tables (views, no copy): one
        rank's shard of a batched instance."""
        if not 0 <= start < stop <= self.batch:
            raise ValueError(f"rows {start}:{stop} of tables for {self.batch} images")
        return EncTables(*(getattr(self, f)[start:stop] for f in self.FIELDS))

    def expand(self, batch: int) -> "EncTables":
        """A one-image table set seen as `batch` images (no copy)."""
        if self.batch == batch:
            return self
        if self.batch != 1:
            raise ValueError(f"tables for {self.batch} images, batch {batch}")
        return EncTables(*(getattr(self, f).expand(batch, *getattr(self, f).shape[1:])
                           for f in self.FIELDS))


@functools.cache
def _default_fields():
    """The default probabilities' tables as host int32 arrays [1, ...]."""
    t = EncTables.from_probs(T.COEFF_PROBS_DEFAULT)
    return tuple(getattr(t, f).numpy() for f in EncTables.FIELDS)

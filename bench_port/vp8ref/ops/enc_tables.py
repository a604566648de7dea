"""Frozen copy of the plain code of `webp_tpu_torch/ops/enc_tables.py`, the
benchmark's reference; it imports nothing of the port.

Kernel K7: per-image rate tables from adapted token probabilities.

Replaces `webp_tpu/ops/encode_wavefront2.py:1405` `enc_tables_from_probs`:
probabilities [B, 4, 8, 3, 11] uint8 -> `EncTables` (pos_cost
[B, 4, 16, 3, 68], cls_cost [B, 4, 16, 3, 11], eob_cost and init_cost
[B, 4, 16, 3], int32), the same values as the host `LevelCosts`.  The JAX
form sums the level codes' bit costs with byte-split float einsums (exact
in bf16); here they are integer sums over the level-code masks.

`enc_tables_plain` is the plain torch form (any device).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _consts
from ..encode import tables as ET
from ..encode.costs import BANDS, LC_A0, LC_A1
from .enc_params import CLS_REPS, EncTables


def enc_tables_plain(probs: torch.Tensor) -> EncTables:
    """Torch twin of the K7 kernel (any device)."""
    dev = probs.device
    ent = _consts.device_constant("entropy_cost", ET.VP8_ENTROPY_COST, dev)
    p = probs.long()                       # [B, 4, 8, 3, 11]
    e1 = ent[255 - p]                      # cost of a 1 bit at each node
    e0 = ent[p]                            # ... and of a 0 bit
    cost0 = torch.cat([torch.zeros_like(e1[..., :1, 0]), e1[..., 1:, 0]], dim=-1)  # [B, 4, 8, 3]
    a1 = torch.from_numpy(LC_A1.astype(np.int32)).to(dev)
    a0 = torch.from_numpy(LC_A0.astype(np.int32)).to(dev)
    var = (e1[..., None, 2:] * a1).sum(-1, dtype=torch.int32) + \
        (e0[..., None, 2:] * a0).sum(-1, dtype=torch.int32)          # [B, 4, 8, 3, 67]
    lc = torch.cat([(e0[..., 1] + cost0)[..., None], (e1[..., 1] + cost0)[..., None] + var], -1)
    bands = torch.from_numpy(BANDS).to(dev)
    pos_cost = lc[:, :, bands].contiguous()
    return EncTables(pos_cost, pos_cost[..., torch.from_numpy(CLS_REPS).to(dev)].contiguous(),
                     e0[..., 0][:, :, bands].contiguous(), e1[..., 0][:, :, bands].contiguous())

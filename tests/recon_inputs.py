"""Seeded inputs of the recon + loop-filter kernels (K2, K3 and their
fusion), for `test_torch_recon_filter.py` and the card tests.  Imports no
jax, so the card tests can use it where only PyTorch is installed."""

from __future__ import annotations

import numpy as np
import torch


def random_inputs(mbw: int, mbh: int, seed: int, batch: int = 2):
    """(residuals int32 [B, nmb, 24, 16], luma_mode, bpred [B, nmb, 16],
    chroma_mode, level, interior, hev uint8 [B, nmb], do_sub bool [B, nmb]),
    seeded: every luma, B and chroma mode, residues of +-30, and about a
    fifth of the MBs (at least one, and never all) at filter level 0."""
    rng = np.random.RandomState(seed)
    shape = (batch, mbw * mbh)
    on = rng.rand(*shape) > 0.2
    on[0, shape[1] // 2], on[-1, -1] = False, True  # at least one MB of each kind
    arrays = (
        rng.randint(-30, 31, shape + (24, 16)).astype(np.int32),
        rng.randint(0, 5, shape).astype(np.uint8),
        rng.randint(0, 10, shape + (16,)).astype(np.uint8),
        rng.randint(0, 4, shape).astype(np.uint8),
        (rng.randint(1, 64, shape) * on).astype(np.uint8),
        rng.randint(1, 64, shape).astype(np.uint8),
        rng.randint(0, 3, shape).astype(np.uint8),
        rng.rand(*shape) < 0.6,
    )
    return tuple(torch.from_numpy(a) for a in arrays)

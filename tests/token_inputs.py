"""Seeded inputs of the device token coder's tests and of chip_smoke.py:
adversarial boolean op streams, pass-2-like level arrays, MB-header modes,
and host coders part-way through a stream.  Imports neither jax nor the JAX
package.
"""

from __future__ import annotations

import numpy as np

from webp_tpu_torch.encode.boolenc import BoolEncoder

# Adversarial boolean streams: long 0xFF runs and carry chains
# (tests/test_boolenc2.py:62-76).
CARRY_PATTERNS = [
    (np.ones(3000, int), np.full(3000, 255)),
    (np.ones(3000, int), np.full(3000, 1)),
    (np.ones(2000, int), np.full(2000, 254)),
    (np.tile([1, 1, 1, 0], 700), np.tile([255, 255, 255, 1], 700)),
    (np.zeros(1200, int), np.full(1200, 1)),
    (np.tile([1, 0], 1500), np.tile([128, 128], 1500)),
]


def prefix_coders(n: int, seed: int):
    """n host coders, each after a seeded run of ops."""
    rng = np.random.RandomState(seed)
    encs = []
    for _ in range(n):
        enc = BoolEncoder()
        for _ in range(rng.randint(30, 300)):
            enc.write_bool(rng.randint(2), rng.randint(1, 256))
        encs.append(enc)
    return encs


def token_arrays(B: int, mbw: int, mbh: int, seed: int):
    """Seeded pass-2-like arrays: luma_mode [B, nmb] uint8; y2, y, uv levels
    int16 (DCs under a Y2 block, cat-6 levels, skipped MBs, B-mode MBs
    without Y2)."""
    rng = np.random.RandomState(seed)
    nmb = mbw * mbh
    y = (rng.randint(-30, 31, (B, nmb, 16, 16)) * (rng.rand(B, nmb, 16, 16) < 0.2))
    y[rng.rand(B, nmb, 16, 16) < 0.01] = 2000
    uv = rng.randint(-20, 21, (B, nmb, 8, 16)) * (rng.rand(B, nmb, 8, 16) < 0.15)
    y2 = rng.randint(-500, 501, (B, nmb, 16)) * (rng.rand(B, nmb, 16) < 0.4)
    lm = rng.choice([0, 1, 2, 3, 4], (B, nmb))
    skipped = rng.rand(B, nmb) < 0.15
    for a in (y, uv, y2):
        a[skipped] = 0
    y2[lm == 4] = 0
    return [lm.astype(np.uint8)] + [a.astype(np.int16) for a in (y2, y, uv)]


def header_inputs(B: int, mbw: int, mbh: int, seed: int):
    """Seeded MB-header inputs of B images: luma_mode, bpred, chroma_mode,
    segment ids, skip flags, segment-tree probabilities [B, 3], skip_prob [B]."""
    rng = np.random.RandomState(seed)
    nmb = mbw * mbh
    return (rng.choice([0, 1, 2, 3, 4, 4], (B, nmb)).astype(np.uint8),
            rng.randint(0, 10, (B, nmb, 16)).astype(np.uint8),
            rng.randint(0, 4, (B, nmb)).astype(np.uint8),
            rng.randint(0, 4, (B, nmb)).astype(np.uint8),
            rng.rand(B, nmb) < 0.3,
            rng.randint(1, 256, (B, 3)), rng.randint(1, 255, B))

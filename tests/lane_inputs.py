"""Seeded K1 (levels -> residuals) and K4 (yuv2rgb) inputs for the edge
cases of their partitions: the CPU twins' tests
(`test_torch_residual_lanes.py`, `test_torch_yuv_runs.py`) and the card
tests (`test_torch_cuda.py`) use the same arrays.  No jax, no
`webp_tpu` import.

A K1 case is a batch of levels in both upload forms: the sparse one (MB
bitmaps, per-MB values up to `cap`, and the image's ascending escape list
of |level| > 127 with unused slots at nmb * 400 after the used ones) and
the dense int16 one, with seeded dequant tables and per-MB fields.
"""

from __future__ import annotations

import numpy as np

SLOTS = 400

# name -> (mbw, mbh, cap, n_esc, escape layout).  Each has nmb = 15 MBs,
# not a multiple of the kernel's 8 MBs a CTA, and B-predicted MBs beside
# I16 ones.
K1_CASES = {
    # escape runs that end and start at the CTA edge (MBs 7 | 8), one MB's
    # run longer than a warp (40 entries), the first and the last slot
    "cta_edges": (5, 3, 64, 256, "edges"),
    # an image's list of 4,096 used entries and no sentinel
    "full_list": (5, 3, 400, 4096, "full"),
    # MBs with exactly `cap` nonzeros and with more (ranks past cap give 0)
    "at_cap": (3, 5, 24, 64, "cap"),
}
# Widths and heights of the K4 cases, at batch 2 so that the second
# image's base lies off an 8-byte boundary where width * height * 3 does.
K4_SIZES = ([(64, 48), (72, 40), (63, 47), (17, 1), (1, 17), (1, 1)]
            + [(w, h) for w in (7, 9, 15, 17, 33, 767) for h in (1, 2, 3, 511)])


def _escape_positions(layout: str, nmb: int, n_esc: int, rng) -> np.ndarray:
    if layout == "edges":
        pos = [7 * SLOTS + 398, 7 * SLOTS + 399, 8 * SLOTS, 8 * SLOTS + 1, 0, 14 * SLOTS + 399]
        pos += list(3 * SLOTS + rng.choice(SLOTS, 40, replace=False))  # one MB, 40 entries
        pos += list(rng.choice(nmb * SLOTS, 30, replace=False))
        return np.unique(np.array(pos))
    if layout == "full":
        return np.sort(rng.choice(nmb * SLOTS, n_esc, replace=False))
    mbs = [m for m in range(nmb) if m not in (0, 4, 14)]  # not the MBs set at cap
    return np.sort(np.array(mbs)[rng.randint(0, len(mbs), 10)] * SLOTS
                   + rng.choice(SLOTS, 10, replace=False))


def k1_case(name: str, batch: int = 2, seed: int = 0) -> dict:
    """Arrays of K1 case `name` (numpy): bitmap uint8 [B, nmb*50], vals
    int8 [B, nmb, cap], esc_pos int32 / esc_val int16 [B, n_esc], qtab
    int16 [B, 1600], i16buf int16 [B, nmb*400 + 1600] (the dense levels
    then qtab), segment_ids, luma_mode, skipped, non_zero uint8 [B, nmb],
    and nmb."""
    mbw, mbh, cap, n_esc, layout = K1_CASES[name]
    nmb = mbw * mbh
    rng = np.random.RandomState(seed + 17 * len(name))
    out = {k: [] for k in ("bitmap", "vals", "esc_pos", "esc_val", "qtab", "i16buf",
                           "segment_ids", "luma_mode", "skipped", "non_zero")}
    for _ in range(batch):
        levels = (rng.randint(-40, 41, nmb * SLOTS) * (rng.rand(nmb * SLOTS) < 0.08))
        if layout == "cap":  # MB 0 exactly at cap, MB 4 past it, MB 14 far past it
            for m, count in ((0, cap), (4, cap + 5), (14, 3 * cap)):
                levels[m * SLOTS:(m + 1) * SLOTS] = 0
                slots = m * SLOTS + rng.choice(SLOTS, count, replace=False)
                levels[slots] = rng.choice([-3, -1, 1, 2, 9], count)
        big = _escape_positions(layout, nmb, n_esc, rng)
        levels[big] = rng.choice([-2047, -600, -128, 128, 300, 2047], len(big))
        levels = levels.astype(np.int16)
        i8 = np.clip(levels, -128, 127).astype(np.int8).reshape(nmb, SLOTS)
        mask = i8 != 0
        vals = np.zeros((nmb, cap), np.int8)
        for m in range(nmb):
            nz = i8[m][mask[m]][:cap]
            vals[m, :len(nz)] = nz
        used = np.flatnonzero(np.abs(levels) > 127)
        assert len(used) <= n_esc
        esc_pos = np.full(n_esc, nmb * SLOTS, np.int32)
        esc_val = np.zeros(n_esc, np.int16)
        esc_pos[:len(used)] = used
        esc_val[:len(used)] = levels[used]
        qtab = rng.randint(1, 300, 4 * 25 * 16).astype(np.int16)
        lm = rng.choice([0, 1, 2, 3, 4], nmb).astype(np.uint8)
        lm[:2] = (4, 0)
        for k, v in (("bitmap", np.packbits(mask.reshape(-1))), ("vals", vals),
                     ("esc_pos", esc_pos), ("esc_val", esc_val), ("qtab", qtab),
                     ("i16buf", np.concatenate([levels, qtab])),
                     ("segment_ids", rng.randint(0, 4, nmb).astype(np.uint8)),
                     ("luma_mode", lm), ("skipped", (rng.rand(nmb) < 0.3).astype(np.uint8)),
                     ("non_zero", (rng.rand(nmb) < 0.7).astype(np.uint8))):
            out[k].append(v)
    case = {k: np.stack(v) for k, v in out.items()}
    case["nmb"] = nmb
    if layout == "full":
        assert (case["esc_pos"] < nmb * SLOTS).all()  # no sentinel
    return case


def k4_planes(width: int, height: int, batch: int = 2, seed: int = 0):
    """MB-padded planes y [B, mbh*16, mbw*16], u, v [B, mbh*8, mbw*8] uint8."""
    mbw, mbh = (width + 15) // 16, (height + 15) // 16
    rng = np.random.RandomState(seed + width * 31 + height)
    return tuple(rng.randint(0, 256, (batch, mbh * n, mbw * n)).astype(np.uint8)
                 for n in (16, 8, 8))

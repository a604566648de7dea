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


def _emitted(k: int) -> int:
    """Bytes a fresh coder has emitted after k range doublings (the first
    after 24, then one every 8)."""
    return 0 if k < 24 else (k - 24) // 8 + 1


def carry_stream(seed: int, runs=(0, 1, 3, 7, 20)):
    """A seeded op stream that makes the coder carry: (bits, probs, split).

    Carries are rare in random streams (a handful in millions of bytes),
    so the bits are steered: the coder's interval, followed exactly in big
    integers (value in units of the initial [0, 256)), is narrowed just
    below a byte boundary B inside it until `run` 0xFF bytes have left after B's last
    digit, then just above B, which carries through them; random bits
    follow each such event.  `split` is an op index after which the
    stream's bytes so far end just before the first event's 0xFF run: a
    coder continued from there (its first `split` ops on the host) carries
    past its first byte, into `lead`."""
    rng = np.random.RandomState(seed)
    bits, probs = [], []
    low, width, k = 0, 255, 0  # the interval [low, low + width) / 2^k
    split = None

    def op(bit, prob):
        nonlocal low, width, k
        s = 1 + (((width - 1) * prob) >> 8)
        low, width = (low + s, width - s) if bit else (low, s)
        while width < 128:
            low, width, k = low << 1, width << 1, k + 1
        bits.append(bit)
        probs.append(prob)

    def steer(num, den, until):  # bits toward the value num / den until until()
        while not until():
            prob = int(rng.randint(1, 256))
            s = 1 + (((width - 1) * prob) >> 8)
            if (low + s) * b_den == b_num << k:
                continue  # a split at B itself would leave B on the interval's edge
            op(int(num << k >= (low + s) * den), prob)

    for _ in range(30):
        op(int(rng.randint(2)), int(rng.randint(1, 256)))
    for run in runs:
        while True:  # a byte boundary B strictly inside the interval, 1/256^j apart
            j = max(1, (k - 1) // 8)
            b_den = 256 ** j
            b_num = (low * b_den) // (1 << k) + 1  # B = b_num / b_den, the first boundary > low
            if (b_num << k) < (low + width) * b_den:
                break
            op(int(rng.randint(2)), int(rng.randint(1, 256)))
        ext = 256 ** (run + 12)
        steer(b_num * ext - 1, b_den * ext, lambda: _emitted(k) >= j + run + 1)
        if split is None:  # after the last nonzero digit of B, which the carry reaches
            last = j - (len(bin(b_num & -b_num)) - 3) // 8
            split = next(i for i in range(len(bits) + 1)
                         if _emitted(_doublings(bits[:i], probs[:i])) > last)
        steer(b_num * ext + 1, b_den * ext, lambda: low * b_den >= b_num << k)
        for _ in range(int(rng.randint(20, 60))):
            op(int(rng.randint(2)), int(rng.randint(1, 256)))
    return np.asarray(bits, int), np.asarray(probs, int), split


def _doublings(bits, probs) -> int:
    """Range doublings of a fresh coder after the ops."""
    width, k = 255, 0
    for bit, prob in zip(bits, probs):
        s = 1 + (((width - 1) * prob) >> 8)
        width = width - s if bit else s
        while width < 128:
            width, k = width << 1, k + 1
    return k


def carrying_state(bits, probs, seed: int):
    """The (bottom, range, bit_num) of a host coder part-way through a
    `carry_stream` (seeds seed, seed + 1, ...; from its `split` on, as its
    steering brings the interval's low end up to just below a byte boundary
    inside it): the first from which coding the ops (bits, probs) carries
    into the bytes the host wrote, so that a lane continued from it reports
    `lead` > 0."""
    for s in range(seed, seed + 8):
        b0, p0, split = carry_stream(s)
        enc = BoolEncoder()
        for k, (bit, prob) in enumerate(zip(b0, p0)):
            if k >= split:
                state, before = (enc.bottom, enc.range, enc.bit_num), bytes(enc.out)
                trial = BoolEncoder()
                trial.out, trial.bottom, trial.range, trial.bit_num = bytearray(before), *state
                for b, p in zip(bits, probs):
                    trial.write_bool(int(b), int(p))
                if bytes(trial.out[:len(before)]) != before:
                    return state
            enc.write_bool(int(bit), int(prob))
    raise ValueError("no steered prefix makes these ops carry into it")


def steered_lanes(n: int, seed: int, continued: bool):
    """n `carry_stream`s (seeds seed, seed + 1, ...) as lanes: bits, probs,
    valid uint8 [T, n], and the coders' initial (bottom, range, bit_num),
    three lists of n: fresh, or continued from a host coder that wrote
    each stream's first `split` ops (so that a carry reaches `lead`)."""
    streams, state = [], [[], [], []]
    for s in range(seed, seed + n):
        bits, probs, split = carry_stream(s)
        enc = BoolEncoder()
        if continued:
            for bit, prob in zip(bits[:split], probs[:split]):
                enc.write_bool(int(bit), int(prob))
            bits, probs = bits[split:], probs[split:]
        streams.append((bits, probs))
        for k, name in enumerate(("bottom", "range", "bit_num")):
            state[k].append(getattr(enc, name))
    T = max(len(b) for b, _ in streams)
    out = np.zeros((3, T, n), np.uint8)
    for lane, (b, p) in enumerate(streams):
        out[0, :len(b), lane], out[1, :len(b), lane], out[2, :len(b), lane] = b, p, 1
    return out[0], out[1], out[2], state

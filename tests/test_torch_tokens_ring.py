"""K13's redesign on the CPU: the device coder step and K13's schedule as
plain twins, against the JAX package.

`ops/boolenc2.lane_coder_plain` is the step of `csrc/boolenc.cuh` (the
closed-form renormalisation, bytes stored as they leave, carries marked and
applied after the lane's last op): it must equal the carry-lookahead twin
`bool_encode_lanes_plain` and the JAX package's `bool_encode_lanes` in every
field, on the adversarial carry patterns, on seeded random streams and on
streams steered to carry through 0xFF runs and, continued from a host
coder, past the lane's first byte.  `ops/token_ops.
encode_coeff_partitions_ring_plain` walks K13's order (producer warps and
the coder warp as generators in seeded orders, a ring that wraps, the
counters) and must equal `encode_coeff_partitions_plain` and the JAX
package's `encode_coeff_partitions`; a ring one op short of the
producers' rule, or a coder that does not wait, must break it.

Inputs are made from numpy seeds (`tests/token_inputs.py`).  Tolerance: 0
(integer coder state and bytes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.ops import boolenc2 as jbool
from webp_tpu.ops import token_ops as jtok
from webp_tpu_torch.encode.boolenc import BoolEncoder
from webp_tpu_torch.ops import boolenc2, token_ops

from token_inputs import CARRY_PATTERNS, carry_stream, prefix_coders, steered_lanes, token_arrays


def _lanes(streams):
    T, L = max(len(b) for b, _ in streams), len(streams)
    out = np.zeros((3, T, L), np.int32)
    for lane, (b, p) in enumerate(streams):
        out[0, :len(b), lane], out[1, :len(b), lane], out[2, :len(b), lane] = b, p, 1
    return out[0], out[1], out[2]


def _case(case: str, init: str):
    """bits, probs, valid [T, L] and the initial (bottom, range, bit_num) lists."""
    if case == "steered":
        return steered_lanes(5, 30, init == "continued")
    if case == "carries":
        streams = CARRY_PATTERNS
    else:
        rng = np.random.RandomState(int(case[-1]))
        streams = [(rng.randint(0, 2, n), rng.randint(1, 256, n)) for n in rng.randint(1, 4000, 9)]
    bits, probs, valid = _lanes(streams)
    encs = (prefix_coders(len(streams), 7) if init == "continued"
            else [BoolEncoder() for _ in streams])
    return bits, probs, valid, [[getattr(e, k) for e in encs] for k in ("bottom", "range",
                                                                         "bit_num")]


def _jax_lanes(bits, probs, valid, cap, state):
    lead, data, n, (bottom, rng, bit_num) = jbool.bool_encode_lanes(
        jnp.asarray(bits.astype(np.int32)), jnp.asarray(probs.astype(np.int32)),
        jnp.asarray(valid.astype(np.int32)), cap,
        init_state=(jnp.asarray(np.asarray(state[0], np.uint32)),
                    *(jnp.asarray(np.asarray(s, np.int32)) for s in state[1:])))
    return {"lead": lead, "data": data, "n_bytes": n, "bottom": bottom, "range": rng,
            "bit_num": bit_num}


def _field(lanes, name):
    return getattr(lanes, name).numpy().astype(np.int64)


@pytest.mark.parametrize("init", ["fresh", "continued"])
@pytest.mark.parametrize("case", ["carries", "seed0", "seed1", "seed2", "steered"])
def test_lane_coder_matches_plain_and_jax(case, init):
    bits, probs, valid, state = _case(case, init)
    cap = 4096
    args = [torch.from_numpy(a.astype(np.int64)) for a in (bits, probs, valid)]
    init_state = [torch.tensor(s) for s in state]
    got = boolenc2.lane_coder_plain(*args, cap, init_state)
    want = boolenc2.bool_encode_lanes_plain(*args, cap, init_state)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    jax_out = _jax_lanes(bits, probs, valid, cap, state)
    for name, w in jax_out.items():
        np.testing.assert_array_equal(_field(got, name), np.asarray(w).astype(np.int64))
    np.testing.assert_array_equal(_field(got, "n_ops"), valid.sum(0))


def test_lane_coder_overflow_counts_exactly():
    """A 40-byte capacity that every lane outgrows: n_bytes, the final
    registers and n_ops stay exact (the wrapper relaunches from n_bytes);
    lanes that fit keep their bytes and lead too.  An overflowing lane's
    bytes are not valid: the twins keep different parts of them."""
    bits, probs, valid, state = _case("seed1", "continued")
    cap = 40
    args = [torch.from_numpy(a.astype(np.int64)) for a in (bits, probs, valid)]
    init_state = [torch.tensor(s) for s in state]
    got = boolenc2.lane_coder_plain(*args, cap, init_state)
    want = boolenc2.bool_encode_lanes_plain(*args, cap, init_state)
    jax_out = _jax_lanes(bits, probs, valid, cap, state)
    over = _field(want, "n_bytes") > cap
    assert over.any() and (~over).any()
    for name in ("n_bytes", "bottom", "range", "bit_num"):
        np.testing.assert_array_equal(_field(got, name), _field(want, name))
        np.testing.assert_array_equal(_field(got, name), np.asarray(jax_out[name]).astype(np.int64))
    np.testing.assert_array_equal(_field(got, "n_ops"), _field(want, "n_ops"))
    for name in ("lead", "data"):
        np.testing.assert_array_equal(_field(got, name)[~over], _field(want, name)[~over])
        np.testing.assert_array_equal(_field(got, name)[~over],
                                      np.asarray(jax_out[name]).astype(np.int64)[~over])


def test_steered_streams_carry():
    """The steered streams make the coder carry (which random streams
    almost never do), and a continued lane's carry reaches `lead`."""
    carries = 0
    for seed in range(30, 35):
        bits, probs, split = carry_stream(seed)
        coder = boolenc2.LaneCoderPlain(boolenc2.INIT_STATE, 4096)
        for bit, prob in zip(bits, probs):
            coder.put(int(bit), int(prob))
        carries += len(coder.marks)
    assert carries >= 5
    bits, probs, valid, state = steered_lanes(5, 30, True)
    lanes = boolenc2.lane_coder_plain(*(torch.from_numpy(a.astype(np.int64))
                                        for a in (bits, probs, valid)), 4096,
                                      [torch.tensor(s) for s in state])
    assert int(lanes.lead.sum()) >= 3


def _dense(mbw: int, mbh: int, seed: int):
    """Every level at +-2048 (chroma +-2047), luma modes alternating
    whole-MB and B: about 7.3K ops an MB."""
    rng = np.random.RandomState(seed)
    nmb = mbw * mbh
    lm = np.where(np.arange(nmb) % 2 == 0, 0, 4)[None].astype(np.uint8)
    y2 = (2048 * rng.choice([-1, 1], (1, nmb, 16))).astype(np.int16)
    y2[lm == 4] = 0
    y = (2048 * rng.choice([-1, 1], (1, nmb, 16, 16))).astype(np.int16)
    uv = (2047 * rng.choice([-1, 1], (1, nmb, 8, 16))).astype(np.int16)
    return [lm, y2, y, uv]


def _mostly_b(mbw: int, mbh: int, seed: int, all_b: bool):
    """B luma modes everywhere (no Y2 block), or but for a few MBs, whose
    Y2 contexts walk past the B MBs to the nearest MB with a Y2 block."""
    arrays = token_arrays(1, mbw, mbh, seed)
    lm = np.full_like(arrays[0], 4)
    if not all_b:
        lm[0, [0, 2, mbw + 3, 3 * mbw - 1, mbw * mbh - 1]] = [1, 0, 2, 3, 0]
    y2 = arrays[1].copy()
    y2[lm == 4] = 0
    return [lm, y2, *arrays[2:]]


# name -> (arrays [B, ...], mbw, mbh, nparts, ring, check against JAX)
RING_CASES = {
    "6x5_p1": (lambda: token_arrays(2, 6, 5, 41), 6, 5, 1, 64, True),
    "6x5_p8": (lambda: token_arrays(2, 6, 5, 42), 6, 5, 8, 96, False),
    "1_mb_wide": (lambda: token_arrays(2, 1, 7, 43), 1, 7, 2, 64, False),
    "all_skipped": (lambda: [np.zeros_like(a) for a in token_arrays(1, 4, 3, 44)], 4, 3, 2, 64,
                    False),
    "all_b": (lambda: _mostly_b(6, 5, 45, True), 6, 5, 2, 64, False),
    "mostly_b_y2_walk": (lambda: _mostly_b(6, 5, 46, False), 6, 5, 2, 64, True),
    "dense_2048": (lambda: _dense(2, 2, 47), 2, 2, 1, 4096, True),
}


def _ring_inputs(name):
    make, mbw, mbh, nparts, ring, _ = RING_CASES[name]
    arrays = make()
    probs = np.random.RandomState(len(name)).randint(1, 256, (arrays[0].shape[0], 1056))
    return [torch.from_numpy(a) for a in arrays], torch.from_numpy(probs.astype(np.uint8))


@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_schedule_matches_plain_and_jax(name):
    _, mbw, mbh, nparts, ring, with_jax = RING_CASES[name]
    arrays, probs = _ring_inputs(name)
    cap = 1 << 15
    want = token_ops.encode_coeff_partitions_plain(*arrays, probs, mbw, mbh, nparts, cap)
    if name == "dense_2048":
        assert int(want.n_ops.max()) > 2 * ring  # every MB writes in rounds
    if name == "all_skipped":
        assert int(want.n_ops.sum()) == 0
    for seed in range(2):
        got = token_ops.encode_coeff_partitions_ring_plain(*arrays, probs, mbw, mbh, nparts, cap,
                                                           seed=seed, ring=ring)
        for g, w in zip(got, want):
            assert torch.equal(g, w), seed
    if not with_jax:
        return
    lm, y2, y, uv = (a[0].numpy().astype(np.int32) for a in arrays)
    lead, data, n, state, n_ops = jtok.encode_coeff_partitions(
        jnp.asarray(y2), jnp.asarray(y), jnp.asarray(uv), jnp.asarray(lm),
        jnp.asarray(probs[0].numpy().astype(np.int32)), mbw, mbh, nparts,
        max_ops=int(want.n_ops.max()) + 64, max_bytes=cap)
    n = np.asarray(n)
    for field, w in zip((want.lead, want.n_bytes, want.n_ops, want.bottom, want.range,
                         want.bit_num), (lead, n, n_ops, *state)):
        np.testing.assert_array_equal(field[0].numpy(), np.asarray(w).astype(np.int64))
    for p in range(nparts):
        np.testing.assert_array_equal(want.data[0, p, :n[p]].numpy(), np.asarray(data)[p, :n[p]])


@pytest.mark.parametrize("broken", ["ring_one_short", "no_wait"])
def test_ring_schedule_needs_the_rule(broken):
    """Producers that count a ring of `ring` ops while it holds ring - 1
    overwrite ops the coder has not read; a coder that does not wait on
    `avail` reads slots not yet written.  Either differs on some seed."""
    _, mbw, mbh, nparts, ring, _ = RING_CASES["6x5_p1"]
    arrays, probs = _ring_inputs("6x5_p1")
    cap = 1 << 15
    want = token_ops.encode_coeff_partitions_plain(*arrays, probs, mbw, mbh, nparts, cap)
    kw = {"slots": ring - 1} if broken == "ring_one_short" else {"wait": False}
    differs = []
    for seed in range(3):
        got = token_ops.encode_coeff_partitions_ring_plain(*arrays, probs, mbw, mbh, nparts, cap,
                                                           seed=seed, ring=ring, **kw)
        differs.append(not all(torch.equal(g, w) for g, w in zip(got, want)))
    assert any(differs)

"""The device token coder's plain twins on the CPU against the JAX package:
`block_ops`, `bool_encode_lanes`, `encode_coeff_partitions` and
`encode_mb_headers` of `webp_tpu_torch/ops/{token_ops,boolenc2}.py` against
`webp_tpu/ops/{token_ops,boolenc2}.py` (run on the CPU as its own tests run
them), field by field, on inputs made from numpy seeds; the lanes' bytes
also against the port's host coders (`BoolEncoder`, the C++ MB-header
coder).  Also the wrappers' relaunch when a lane outgrows its byte
capacity.  Tolerance: 0 (integer coder state and bytes).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from webp_tpu.ops import boolenc2 as jbool
from webp_tpu.ops import token_ops as jtok
from webp_tpu_torch.encode.boolenc import BoolEncoder, assemble_lane
from webp_tpu_torch.io import native
from webp_tpu_torch.ops import boolenc2, token_ops

from token_inputs import CARRY_PATTERNS, header_inputs, prefix_coders, token_arrays


def _jax_state(state):
    return tuple(np.asarray(x).astype(np.int64) for x in state)


def _levels_cases(rng, n):
    """[n, 16] level blocks: empty, small runs, one big (cat-6) level, dense
    mid-size levels, a mix; position 0 set too (a Y DC at first = 1)."""
    cases = []
    for k in range(n):
        lv = np.zeros(16, np.int64)
        kind = k % 5
        if kind == 1:
            m = rng.randint(1, 16)
            lv[:m] = rng.randint(-4, 5, m)
        elif kind == 2:
            lv[rng.randint(16)] = rng.randint(1, 2048) * rng.choice([-1, 1])
        elif kind == 3:
            lv = rng.randint(-80, 81, 16)
        elif kind == 4:
            lv = rng.choice([0, 0, 0, 1, -1, 2, -2, 5, -7, 12, 40, -70, 600], 16)
        if rng.rand() < 0.5:
            lv[0] = rng.randint(-300, 301)
        cases.append(lv)
    return np.stack(cases).astype(np.int32)


@pytest.mark.parametrize("ctx", [0, 1, 2])
@pytest.mark.parametrize("plane,first", [(0, 1), (1, 0), (2, 0), (3, 0)])
def test_block_ops_matches_jax(plane, first, ctx):
    rng = np.random.RandomState(plane * 10 + first * 3 + ctx)
    probs = rng.randint(1, 256, 1056).astype(np.uint8)
    lv = _levels_cases(rng, 40)
    meta = [np.full(len(lv), x, np.int32) for x in (plane, first, ctx)]
    want = jtok.block_ops(jnp.asarray(lv), *(jnp.asarray(m) for m in meta),
                          jnp.asarray(probs.astype(np.int32)))
    got = token_ops.block_ops(torch.from_numpy(lv), *(torch.from_numpy(m) for m in meta),
                              torch.from_numpy(probs))
    assert got[0].shape == (len(lv), token_ops.SLOTS) == (len(lv), jtok.SLOTS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _streams(case: str):
    if case == "carries":
        return CARRY_PATTERNS
    rng = np.random.RandomState(int(case[-1]))
    return [(rng.randint(0, 2, n), rng.randint(1, 256, n))
            for n in rng.randint(1, 4000, 9)]


@pytest.mark.parametrize("init", ["fresh", "continued"])
@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "carries"])
def test_bool_encode_lanes_matches_jax(case, init):
    streams = _streams(case)
    T, L = max(len(b) for b, _ in streams), len(streams)
    bits, probs, valid = np.zeros((T, L), np.int32), np.ones((T, L), np.int32), np.zeros((T, L),
                                                                                         np.int32)
    for lane, (b, p) in enumerate(streams):
        bits[:len(b), lane], probs[:len(p), lane], valid[:len(b), lane] = b, p, 1
    encs = prefix_coders(L, 7) if init == "continued" else [BoolEncoder() for _ in range(L)]
    state = [np.array([getattr(e, k) for e in encs]) for k in ("bottom", "range", "bit_num")]
    cap = 4096
    lead, data, n, jstate = jbool.bool_encode_lanes(
        jnp.asarray(bits), jnp.asarray(probs), jnp.asarray(valid), cap,
        init_state=(jnp.asarray(state[0].astype(np.uint32)),
                    *(jnp.asarray(s.astype(np.int32)) for s in state[1:])))
    got = boolenc2.bool_encode_lanes(*(torch.from_numpy(a) for a in (bits, probs, valid)), cap,
                                     init_state=[torch.from_numpy(s) for s in state])
    assert (np.asarray(n) <= cap).all()
    np.testing.assert_array_equal(got.lead.numpy(), np.asarray(lead))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(data))
    np.testing.assert_array_equal(got.n_bytes.numpy(), np.asarray(n))
    for g, w in zip((got.bottom, got.range, got.bit_num), _jax_state(jstate)):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(got.n_ops.numpy(), valid.sum(0))
    for lane, (enc, (b, p)) in enumerate(zip(encs, streams)):
        prefix = bytes(enc.out)
        for bit, prob in zip(b, p):
            enc.write_bool(int(bit), int(prob))
        want = assemble_lane(0, np.zeros(0, np.uint8), 0, enc.bottom, enc.bit_num, bytes(enc.out))
        assert assemble_lane(int(got.lead[lane]), got.data[lane].numpy(), int(got.n_bytes[lane]),
                             int(got.bottom[lane]), int(got.bit_num[lane]), prefix) == want


@pytest.mark.parametrize("nparts", [1, 2, 4, 8])
def test_encode_coeff_partitions_matches_jax(nparts):
    """6x5 MBs: at 8 partitions the last three lanes are empty."""
    mbw, mbh = 6, 5
    arrays = token_arrays(2, mbw, mbh, nparts)
    probs = np.random.RandomState(nparts + 50).randint(1, 256, (2, 1056)).astype(np.uint8)
    got = token_ops.encode_coeff_partitions(*(torch.from_numpy(a) for a in arrays),
                                            torch.from_numpy(probs), mbw, mbh, nparts)
    for b in range(2):
        lm, y2, y, uv = (a[b].astype(np.int32) for a in arrays)
        lead, data, n, state, n_ops = jtok.encode_coeff_partitions(
            jnp.asarray(y2), jnp.asarray(y), jnp.asarray(uv), jnp.asarray(lm),
            jnp.asarray(probs[b].astype(np.int32)), mbw, mbh, nparts, max_ops=10 ** 6,
            max_bytes=8192)
        n = np.asarray(n)
        for field, want in zip((got.lead, got.n_bytes, got.n_ops), (lead, n, n_ops)):
            np.testing.assert_array_equal(field[b].numpy(), np.asarray(want))
        for field, want in zip((got.bottom, got.range, got.bit_num), _jax_state(state)):
            np.testing.assert_array_equal(field[b].numpy(), want)
        for p in range(nparts):
            np.testing.assert_array_equal(got.data[b, p, :n[p]].numpy(), np.asarray(data)[p, :n[p]])
    if nparts == 8:
        assert (got.n_ops[:, mbh:] == 0).all() and (got.n_bytes[:, mbh:] == 0).all()


@pytest.mark.parametrize("write_segments", [True, False], ids=["segment_map", "no_map"])
def test_encode_mb_headers_matches_jax(write_segments):
    """Two images continue host coders that wrote a seeded prefix; the op
    slots (`header_ops`) and the header lanes equal the JAX package's and,
    assembled, the lanes equal the C++ coder's output."""
    B, mbw, mbh = 2, 5, 4
    lm, bp, cm, sid, sk, seg_probs, skip_prob = header_inputs(B, mbw, mbh, 13)
    encs = prefix_coders(B, 3)
    state = [[getattr(e, k) for e in encs] for k in ("bottom", "range", "bit_num")]
    params = token_ops.header_params([write_segments] * B, seg_probs, skip_prob, state, "cpu")
    got = token_ops.encode_mb_headers(*(torch.from_numpy(a) for a in (lm, bp, cm, sid, sk)),
                                      params, mbw, mbh)
    for b, enc in enumerate(encs):
        ops = token_ops.header_ops(*(torch.from_numpy(a[b]) for a in (lm, bp, cm, sid, sk)),
                                   seg_probs[b], skip_prob[b], write_segments, mbw, mbh)
        want_ops = jtok.header_ops(*(jnp.asarray(a[b].astype(np.int32)) for a in (lm, bp, cm, sid,
                                                                                   sk)),
                                   jnp.asarray(seg_probs[b].astype(np.int32)),
                                   jnp.asarray(np.int32(skip_prob[b])), write_segments, mbw, mbh)
        assert ops[0].shape == (mbw * mbh, token_ops.HEADER_SLOTS) == (mbw * mbh, jtok.HEADER_SLOTS)
        for g, w in zip(ops, want_ops):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        lead, data, n, jstate, n_ops = jtok.encode_mb_headers(
            *(jnp.asarray(a[b].astype(np.int32)) for a in (lm, bp, cm, sid, sk)),
            jnp.asarray(seg_probs[b].astype(np.int32)), jnp.asarray(np.int32(skip_prob[b])),
            (jnp.asarray(np.uint32(enc.bottom)), jnp.asarray(np.int32(enc.range)),
             jnp.asarray(np.int32(enc.bit_num))),
            mbw, mbh, write_segments, max_ops=mbw * mbh * 120, max_bytes=4096)
        n = int(n)
        assert (int(got.lead[b]), int(got.n_bytes[b]), int(got.n_ops[b])) == (int(lead), n,
                                                                               int(n_ops))
        np.testing.assert_array_equal(got.data[b, :n].numpy(), np.asarray(data)[:n])
        assert [int(x[b]) for x in (got.bottom, got.range, got.bit_num)] == \
            [int(x) for x in _jax_state(jstate)]
        mine = assemble_lane(int(got.lead[b]), got.data[b].numpy(), n, int(got.bottom[b]),
                             int(got.bit_num[b]), bytes(enc.out))
        want = native.vp8_mbheader_encode(enc, lm[b], bp[b], cm[b], sk[b], mbw, int(skip_prob[b]),
                                          sid[b], write_segments, seg_probs[b])
        assert mine == want


@pytest.mark.parametrize("coder", ["partitions", "headers"])
def test_overflow_relaunches_at_the_reported_size(coder, monkeypatch):
    """A 16-byte capacity overflows; the wrapper runs the coder again at the
    largest reported count, and the result is that of an ample capacity."""
    if coder == "partitions":
        name = "encode_coeff_partitions_plain"
        arrays = [torch.from_numpy(a) for a in token_arrays(2, 4, 3, 21)]
        probs = torch.from_numpy(np.random.RandomState(4).randint(1, 256, (2, 1056))
                                 .astype(np.uint8))

        def call(cap):
            return token_ops.encode_coeff_partitions(*arrays, probs, 4, 3, 2, capacity=cap)
    else:
        name = "encode_mb_headers_plain"
        lm, bp, cm, sid, sk, seg_probs, skip_prob = header_inputs(2, 6, 5, 8)
        device = [torch.from_numpy(a) for a in (lm, bp, cm, sid, sk)]

        params = token_ops.header_params([True, False], seg_probs, skip_prob,
                                         [[0, 0], [255, 255], [24, 24]], "cpu")

        def call(cap):
            return token_ops.encode_mb_headers(*device, params, 6, 5, capacity=cap)
    caps = []
    plain = getattr(token_ops, name)
    monkeypatch.setattr(token_ops, name, lambda *a: (caps.append(a[-1]), plain(*a))[1])
    got, want = call(16), call(1 << 16)
    need = int(want.n_bytes.max())
    assert need > 16 and caps == [16, need, 1 << 16]
    assert got.data.shape[-1] == want.data.shape[-1] == need
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_second_overflow_raises():
    def run(cap):
        n = torch.tensor([cap + 1])
        return boolenc2.Lanes(n, torch.zeros((1, cap), dtype=torch.uint8), n, n, n, n, n)

    with pytest.raises(RuntimeError, match="overflow"):
        token_ops._capacity_run(run, 8)

"""K14's phases on the CPU: the twin of the MB-header kernel's count and
write phases against the JAX package.

`ops/token_ops.header_stream_plain` counts each MB's header ops from the
path lengths, scans the counts, and writes each MB's ops (prob | bit << 8)
at its start in the image's op stream, as `csrc/tokens.cu`
`mb_headers_kernel` does before its coder warp runs.  Its counts and
stream must equal the compaction of the port's and the JAX package's
`header_ops` slots, and the stream coded with the device step
(`encode_mb_headers_phases_plain`) must equal `encode_mb_headers_plain`
and the JAX package's `encode_mb_headers` in every field, with the
segment map written and not; in each case image 0 starts from a fresh
coder and the others continue a host coder steered so that the headers
carry into its bytes (`lead`, `token_inputs.carrying_state`).  The JAX function runs
eagerly (the body under its `jax.jit`, `__wrapped__`) at one `max_ops`, so
that the jitted lane coder inside it compiles once for the file and not
once per shape and setting; integer ops give the same results either
way.  Shapes: 7x5 at batch 3, one MB column, one MB row, every MB in B
mode at the longest paths (119 ops an MB with the map), no MB in B mode,
and 13x11 (143 MBs, not a multiple of the CTA's threads).

Inputs are made from numpy seeds (`tests/token_inputs.py`).  Tolerance: 0
(integer ops, coder state and bytes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.ops import token_ops as jtok
from webp_tpu_torch.ops import boolenc2, token_ops

from token_inputs import carrying_state, header_inputs

# name -> (batch, mbw, mbh, modes).  All but 13x11 hold 35 MBs: the JAX
# function's compaction compiles once per MB count.
SHAPES = {"7x5_b3": (3, 7, 5, "mixed"), "one_column": (2, 1, 35, "mixed"),
          "one_row": (2, 35, 1, "mixed"), "all_b": (2, 7, 5, "all_b"),
          "no_b": (2, 7, 5, "no_b"), "13x11": (2, 13, 11, "mixed")}
MAX_BYTES = 4096
MAX_OPS = 8192  # >= every case's op count


def _modes(shape: str):
    """The five per-MB fields (numpy) and the segment-tree and skip
    probabilities."""
    B, mbw, mbh, modes = SHAPES[shape]
    lm, bp, cm, sid, sk, seg_probs, skip_prob = header_inputs(B, mbw, mbh, mbw * 16 + mbh)
    if modes == "all_b":  # B modes 8 and 9 and chroma modes 2 and 3 take the longest paths
        lm[:] = 4
        bp, cm = 8 + bp % 2, 2 + cm % 2
    elif modes == "no_b":
        lm %= 4
    return (lm, bp, cm, sid, sk), seg_probs, skip_prob


def _packed(ops):
    """The valid slots of `header_ops`, compacted: [n] prob | bit << 8, and
    the valid slots of each MB."""
    prob, bit, valid = (np.asarray(x).astype(np.int64) for x in ops)
    ok = valid.astype(bool)
    return (prob | bit << 8)[ok], ok.sum(-1)


@pytest.mark.parametrize("write_segments", [True, False], ids=["segment_map", "no_map"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_header_stream_matches_jax(shape, write_segments):
    (B, mbw, mbh, _), nmb = SHAPES[shape], SHAPES[shape][1] * SHAPES[shape][2]
    fields, seg_probs, skip_prob = _modes(shape)
    modes = [torch.from_numpy(a) for a in fields]
    jax_ops = [_packed(jtok.header_ops(*(jnp.asarray(a[b].astype(np.int32)) for a in fields),
                                       jnp.asarray(seg_probs[b].astype(np.int32)),
                                       jnp.asarray(np.int32(skip_prob[b])), write_segments, mbw,
                                       mbh)) for b in range(B)]
    # Image 0 from a fresh coder; the others continued from host coders whose
    # bytes their headers carry into (`lead`).
    state = [boolenc2.INIT_STATE] + [carrying_state(ops >> 8, ops & 0xFF, 10 * b)
                                     for b, (ops, _) in enumerate(jax_ops) if b > 0]
    params = token_ops.header_params([write_segments] * B, seg_probs, skip_prob,
                                     np.asarray(state).T, "cpu")

    counts, starts, stream = token_ops.header_stream_plain(*modes, params, mbw, mbh)
    assert stream.shape == (B, token_ops.header_op_capacity(nmb))
    np.testing.assert_array_equal(starts.numpy(), np.cumsum(counts.numpy(), 1) - counts.numpy())
    if SHAPES[shape][3] == "all_b":
        assert (counts == (119 if write_segments else 117)).all()
    for b in range(B):
        mine = _packed(token_ops.header_ops(*(m[b] for m in modes), seg_probs[b], skip_prob[b],
                                            write_segments, mbw, mbh))
        total = int(counts[b].sum())
        for packed, per_mb in (mine, jax_ops[b]):
            np.testing.assert_array_equal(counts[b].numpy(), per_mb)
            np.testing.assert_array_equal(stream[b, :total].numpy(), packed)
        assert not stream[b, total:].any()

    got = token_ops.encode_mb_headers_phases_plain(*modes, params, mbw, mbh, MAX_BYTES)
    want = token_ops.encode_mb_headers_plain(*modes, params, mbw, mbh, MAX_BYTES)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got.lead[1:] > 0).all()
    for b in range(B):
        assert int(counts[b].sum()) <= MAX_OPS
        lead, data, n, jstate, n_ops = jtok.encode_mb_headers.__wrapped__(
            *(jnp.asarray(a[b].astype(np.int32)) for a in fields),
            jnp.asarray(seg_probs[b].astype(np.int32)), jnp.asarray(np.int32(skip_prob[b])),
            (jnp.asarray(np.uint32(params[b, 5])), jnp.asarray(np.int32(params[b, 6])),
             jnp.asarray(np.int32(params[b, 7]))),
            mbw, mbh, write_segments, max_ops=MAX_OPS, max_bytes=MAX_BYTES)
        n = int(n)
        assert [int(x[b]) for x in (got.lead, got.n_bytes, got.n_ops)] == [int(lead), n,
                                                                          int(n_ops)]
        np.testing.assert_array_equal(got.data[b, :n].numpy(), np.asarray(data)[:n])
        assert [int(x[b]) for x in (got.bottom, got.range, got.bit_num)] == \
            [int(np.asarray(x)) for x in jstate]

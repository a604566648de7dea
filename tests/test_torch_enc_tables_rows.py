"""Kernel K7 (rate tables, `webp_tpu_torch/csrc/enc_tables.cu`): the
kernel's schedule on the CPU, against the plain twin and the JAX package.

`enc_tables_rows_plain` below walks the kernel's one schedule (kept here,
beside its tests, since no caller of the package needs it): a CTA per
(image, type); the type's 264 probability bytes as 33 8-byte loads and the
table (entropy costs, then the level codes' (pattern, bits)) in one wave;
the 24 distinct (band, ctx) rows x 68 levels computed once, a lane a row
holding the row's node costs ent[p] (a 0 bit) and ent[255 - p] (a 1 bit),
warp w taking levels w, w + 8, ..., so that the level's code is the same
across the warp and its nodes 2..10 unroll into selects; then
the 16-byte stores: each (position, ctx) row of pos_cost (17 int4) from
the row of the position's band, cls_cost's int4 of 4 consecutive entries
gathered from the class representatives 0..5, 7, 11, 19, 35, 67 (k < 4 ?
k : 3 + 2^(k - 4)), eob_cost and init_cost from node 0.  The outputs start
filled with a sentinel, so that an entry no store reaches shows.  It is
held to `enc_tables_plain` and the JAX package's `enc_tables_from_probs`
(`webp_tpu/ops/encode_wavefront2.py:1405`) on seeded probabilities (the
full 0..255 range, the default set, all-0 and all-255 types).  A mutated
schedule (a band's row written to one position fewer) fails.  Tolerance:
bit-exact (integer tables).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.ops.encode_wavefront2 import enc_tables_from_probs
from webp_tpu_torch.common import vp8_tables as T
from webp_tpu_torch.ops.enc_params import EncTables
from webp_tpu_torch.ops.enc_tables import TABLES_NP, enc_tables, enc_tables_plain

WARPS, LEVELS, NODES, ROWS, POS_ROWS, CLS = 8, 68, 11, 24, 48, 11
BAND_NIBBLES = 0x7666666665463210  # the band of position p in nibble p
SENTINEL = -7


def band_of(pos: int) -> int:
    return (BAND_NIBBLES >> (4 * pos)) & 15


def class_rep(k: int) -> int:
    return k if k < 4 else 3 + (1 << (k - 4))


def enc_tables_rows_plain(probs: torch.Tensor, mutation=None) -> EncTables:
    """Twin of K7's schedule: probs uint8 [B, 4, 8, 3, 11] -> EncTables."""
    B = probs.shape[0]
    tables = torch.from_numpy(TABLES_NP).long()
    ent, codes = tables[:256], tables[256:].reshape(-1, 2)
    out = {f: torch.full(s, SENTINEL, dtype=torch.int32) for f, s in (
        ("pos_cost", (B, 4, 16, 3, LEVELS)), ("cls_cost", (B, 4, 16, 3, CLS)),
        ("eob_cost", (B, 4, 16, 3)), ("init_cost", (B, 4, 16, 3)))}
    flat = probs.reshape(B * 4, ROWS * NODES).long()
    for cta in range(B * 4):  # (image, type)
        b, t = divmod(cta, 4)
        words = flat[cta].reshape(ROWS * NODES // 8, 8)  # the 33 8-byte loads
        p = words.reshape(ROWS, NODES)
        e0, e1 = ent[p].T, ent[255 - p].T  # [node][lane]: a lane's registers
        cost = torch.zeros((ROWS, LEVELS), dtype=torch.int64)
        lane = torch.arange(ROWS)
        cost0 = torch.where(lane % 3 > 0, e1[0], 0)
        for warp in range(WARPS):
            for v in range(warp, LEVELS, WARPS):
                if v == 0:
                    cost[:, 0] = e0[1] + cost0
                    continue
                c = e1[1] + cost0
                pattern, bits = int(codes[v - 1, 0]), int(codes[v - 1, 1])
                for node in range(2, NODES):  # unrolled; the branch is warp-uniform
                    if (pattern >> (node - 2)) & 1:
                        c = c + (e1[node] if (bits >> (node - 2)) & 1 else e0[node])
                cost[:, v] = c
        pos_rows = out["pos_cost"][b, t].reshape(POS_ROWS * LEVELS // 4, 4)
        for j in range(POS_ROWS * LEVELS // 4):  # 816 int4 stores
            pr, q = divmod(j, LEVELS // 4)
            pos, ctx = divmod(pr, 3)
            if mutation == "position_fewer" and pos == 14:  # band 6's last position
                continue
            pos_rows[j] = cost[band_of(pos) * 3 + ctx, 4 * q:4 * q + 4]
        cls = out["cls_cost"][b, t].reshape(POS_ROWS * CLS // 4, 4)
        for j in range(POS_ROWS * CLS // 4):  # 132 int4 stores
            for i in range(4):
                pr, k = divmod(4 * j + i, CLS)
                pos, ctx = divmod(pr, 3)
                cls[j, i] = cost[band_of(pos) * 3 + ctx, class_rep(k)]
        for j in range(POS_ROWS // 2):  # 12 int4 of eob, then 12 of init
            eob = j < POS_ROWS // 4
            dst = out["eob_cost" if eob else "init_cost"][b, t].reshape(POS_ROWS // 4, 4)
            jj = j if eob else j - POS_ROWS // 4
            for i in range(4):
                pos, ctx = divmod(4 * jj + i, 3)
                dst[jj, i] = (e0 if eob else e1)[0, band_of(pos) * 3 + ctx]
    return EncTables(*(out[f] for f in EncTables.FIELDS))


@pytest.fixture(scope="module")
def probs():
    rng = np.random.RandomState(23)
    p = rng.randint(0, 256, (3, 4, 8, 3, 11)).astype(np.uint8)
    p[0] = T.COEFF_PROBS_DEFAULT
    p[1, 2] = 0
    p[2, 3] = 255
    return torch.from_numpy(p)


def test_bands_and_representatives_match_the_tables():
    from webp_tpu_torch.encode.costs import BANDS
    from webp_tpu_torch.ops.enc_params import CLS_REPS

    assert [band_of(p) for p in range(16)] == BANDS.tolist()
    assert [class_rep(k) for k in range(CLS)] == CLS_REPS.tolist()
    codes = TABLES_NP[256:].reshape(-1, 2)
    assert codes[:, 0].max() < 1 << (NODES - 2)  # nodes 2..10: every code fits the unroll
    assert not (codes[:, 1] & ~codes[:, 0]).any()


def test_rows_schedule_matches_plain_and_jax(probs):
    got = enc_tables_rows_plain(probs)
    want = enc_tables_plain(probs)
    host = enc_tables(probs)  # the wrapper's CPU path
    jax_t = enc_tables_from_probs(jnp.asarray(probs.numpy()))
    for f in EncTables.FIELDS:
        g = getattr(got, f)
        assert g.dtype == torch.int32 and torch.equal(g, getattr(want, f)), f
        assert torch.equal(g, getattr(host, f)), f
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(jax_t, f)), err_msg=f)


def test_each_distinct_row_covers_its_band(probs):
    """Every (position, ctx) row of pos_cost is its band's row: 16
    positions, 8 distinct rows, each written to all of its positions."""
    got = enc_tables_rows_plain(probs).pos_cost
    assert (got != SENTINEL).all()
    for pos in range(16):
        first = next(q for q in range(16) if band_of(q) == band_of(pos))
        assert torch.equal(got[:, :, pos], got[:, :, first])


@pytest.mark.parametrize("mutation", ["position_fewer"])
def test_mutated_schedule_fails(probs, mutation):
    got = enc_tables_rows_plain(probs, mutation)
    want = enc_tables_plain(probs)
    assert not all(torch.equal(getattr(got, f), getattr(want, f)) for f in EncTables.FIELDS)

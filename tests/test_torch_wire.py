"""The encode wire (`webp_tpu_torch/ops/wire.py`, `ops/sparse.py`) on the CPU
against the JAX package, as its own tests run it (`tests/test_wire_format.py`):

- K19's twin `pack_levels_mb` against `device_pack_levels_mb` on seeded int8
  levels with MBs of exactly 256 and 257 nonzeros;
- K18's twin `prepack` against a numpy transcription of `_prepack_body`'s
  clip and argmax loop, with MBs of 0, 4 and 5 escapes;
- `wire_stage` (K19 + K20's twins) byte-equal to `_wire_stage` on seeded
  levels (B = 3, nmb = 42): plain rows with escapes in the last MB, the
  sp_over flag (an MB over CAP_MB nonzeros, an MB over MED_CAP med
  entries), the overflow flag passed through, and an image of more than
  ESC_IMG escapes;
- the image escape list in integers: at nmb = 45,000 (positions past
  2^24, where the JAX float32 compaction rounds) against an integer numpy
  oracle, and at nmb = 1536 against `_rank_compact`;
- the host half: `unpack_wire` / `unpack_dense_wire` against
  `unpack_analysis_wire` / `unpack_analysis_dense_wire`, the bound C++
  `wire_expand_levels` against `numpy_wire_expand`, and its refusals;
- the slice: `encode_analysis_batch_packed` against
  `encode_analysis_batch_v2_packed` (shared tables) and
  `encode_analysis_batch_v2_pertbl_packed` (per-image tables from pass 1),
  Q100 m3 on 64x48 frames, one of flat saturated tiles (Y2 DC escapes), one
  of seeded noise (sp_over), and the payloads of
  `encode_frames_lossy_batch(..., device="cpu")` against the JAX package's,
  both flows; and `fetch_packed` through each of its branches on the
  seeded arrays of `wire_inputs.py`.

Every JAX compile here is without the trellis.  Tolerance: 0 (integer bytes).
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.encode import vp8 as jvp8
from webp_tpu.encode.quant import SegmentParams as JSegmentParams
from webp_tpu.encode.quant import quality_to_quant_index as jqi
from webp_tpu.ops import encode_wavefront2 as J
from webp_tpu.ops.encode_wavefront import EncParams as JEncParams
from webp_tpu.ops.encode_wavefront import EncTables as JEncTables
from webp_tpu.ops.sparse import device_pack_levels_mb
from webp_tpu_torch.common import vp8_tables as T
from webp_tpu_torch.encode import device as edev
from webp_tpu_torch.io import native
from webp_tpu_torch.ops import wire as W
from webp_tpu_torch.ops.enc_params import EncTables
from webp_tpu_torch.ops.sparse import pack_levels_mb

import webp_tpu_torch
from wire_inputs import wire_arrays

QUALITY = 100
FRAME = (64, 48)  # w, h: 4 x 3 MBs


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nonzeros(rng, n):
    return rng.choice([-1, 1], n) * rng.randint(1, 128, n)


def test_constants_match_jax():
    assert (W.N_ESC, W.CAP_MB, W.MED_CAP, W.ESC_IMG) == (J.N_ESC, J.CAP_MB, J.MED_CAP, J.ESC_IMG)
    for nmb in (1, 42, 1536):
        assert W.wire_bytes(nmb) == J.wire_bytes(nmb)
    assert W.wire_bytes(1536) == 402_434


@pytest.mark.parametrize("cap", [256, 100])
def test_pack_levels_matches_jax(cap):
    rng = np.random.RandomState(1)
    B, nmb = 2, 8
    lv8 = np.zeros((B, nmb, 400), np.int8)
    counts = [[0, 1, 90, 256, 255, 7, 33, 200], [257, 5, 0, 255, 64, 399, 12, 128]]
    for b in range(B):
        for m, n in enumerate(counts[b]):
            lv8[b, m, rng.choice(400, n, replace=False)] = _nonzeros(rng, n)
    got = pack_levels_mb(_t(lv8), cap)
    want = [np.asarray(a) for a in device_pack_levels_mb(jnp.asarray(lv8), cap)]
    for g, w, name in zip(got, want, ("bitmap", "vals", "overflow")):
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got[2].tolist() == ([False, True] if cap == 256 else [True, True])


def _prepack_numpy(arrays):
    """`_prepack_body`'s clip and N_ESC argmax rounds, in numpy."""
    B, nmb = arrays["luma_mode"].shape
    lv = np.concatenate([arrays["y_levels"].reshape(B, nmb, 256),
                         arrays["uv_levels"].reshape(B, nmb, 128), arrays["y2_levels"]],
                        axis=-1).astype(np.int32)
    lv8 = np.clip(lv, -128, 127).astype(np.int8)
    mask = np.abs(lv) > 127
    iota = np.arange(400)
    pos, val = [], []
    for _ in range(J.N_ESC):
        idx = np.argmax(mask, axis=-1)
        found = mask.any(-1)
        v = np.take_along_axis(lv, idx[..., None], axis=-1)[..., 0]
        pos.append(np.where(found, idx, -1).astype(np.int16))
        val.append(np.where(found, v, 0).astype(np.int16))
        mask = mask & (iota != idx[..., None])
    meta8 = np.concatenate([arrays["bpred"], arrays["luma_mode"][..., None],
                            arrays["chroma_mode"][..., None]], axis=-1).astype(np.uint8)
    return lv8, meta8, np.stack(pos, -1), np.stack(val, -1), mask.any((-1, -2))


def _arrays(seed, B, nmb, escapes):
    """Seeded K5-shaped arrays; escapes[b][m] levels with |v| > 127 in MB m."""
    rng = np.random.RandomState(seed)
    lv = (rng.randint(-20, 21, (B, nmb, 400)) * (rng.rand(B, nmb, 400) < 0.3)).astype(np.int32)
    big = np.array([128, -128, 129, -300, 2047, -2048, 32767, -32768])
    for b in range(B):
        for m, n in enumerate(escapes[b]):
            lv[b, m, rng.choice(400, n, replace=False)] = rng.choice(big, n)
    return {
        "y_levels": lv[..., :256].reshape(B, nmb, 16, 16).astype(np.int16),
        "uv_levels": lv[..., 256:384].reshape(B, nmb, 8, 16).astype(np.int16),
        "y2_levels": lv[..., 384:].astype(np.int16),
        "bpred": rng.randint(0, 10, (B, nmb, 16)).astype(np.uint8),
        "luma_mode": rng.randint(0, 5, (B, nmb)).astype(np.uint8),
        "chroma_mode": rng.randint(0, 4, (B, nmb)).astype(np.uint8),
    }, lv


def test_prepack_matches_numpy_transcription():
    arrays, _ = _arrays(2, 2, 6, [[0, 4, 1, 0, 3, 2], [5, 0, 4, 8, 0, 1]])
    got = W.prepack({k: _t(a) for k, a in arrays.items()})
    want = _prepack_numpy(arrays)
    for g, w, name in zip(got, want, ("lv8", "meta8", "esc_pos", "esc_val", "overflow")):
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got[4].tolist() == [False, True]


def _wire_case(case):
    """(lv int32 [B, nmb, 400], meta8, esc_pos, esc_val, overflow, expected
    flags [B, 2])."""
    rng = np.random.RandomState({"plain": 3, "flags": 4, "many_escapes": 5}[case])
    B, nmb = (2, 130) if case == "many_escapes" else (3, 42)
    lv = np.zeros((B, nmb, 400), np.int32)
    for b in range(B):  # tests/test_wire_format.py's level mix
        for m in range(nmb):
            n = rng.choice([0, 5, 90, 200, 248])  # room for 8 escapes under CAP_MB
            pos = rng.choice(400, n, replace=False)
            mag = rng.choice([1, 1, 1, 1, 2, 2, 3], n)
            mag = np.where(rng.rand(n) < 0.02, rng.randint(8, 100, n), mag)
            lv[b, m, pos] = mag * rng.choice([-1, 1], n)
        for m in list(rng.randint(0, nmb, 3)) + [nmb - 1]:  # escapes, one in the last MB
            lv[b, m, rng.randint(400)] = rng.choice([-1, 1]) * rng.randint(128, 900)
    overflow = np.zeros(B, bool)
    flags = np.zeros((B, 2), np.uint8)
    if case == "flags":
        lv[0, 5, :300] = rng.choice([-2, -1, 1, 2], 300)  # 300 nonzeros: over CAP_MB
        lv[1, 7] = 0
        lv[1, 7, rng.choice(400, 40, replace=False)] = 50  # 40 med entries: over MED_CAP
        overflow[2] = True  # an MB of 5+ escapes, from the prepack
        flags[:2, 0] = 1
        flags[2, 1] = 1
    if case == "many_escapes":  # image 0: 4 escapes in every MB, 520 > ESC_IMG
        for m in range(nmb):
            lv[0, m, rng.choice(400, 4, replace=False)] = rng.choice([-1, 1], 4) * 200
        flags[0, 1] = 1
    big = np.abs(lv) > 127
    esc_pos = np.full((B, nmb, J.N_ESC), -1, np.int16)
    esc_val = np.zeros((B, nmb, J.N_ESC), np.int16)
    for b, m in zip(*np.nonzero(big.any(-1))):
        at = np.flatnonzero(big[b, m])[:J.N_ESC]
        esc_pos[b, m, :len(at)] = at
        esc_val[b, m, :len(at)] = lv[b, m, at]
    meta8 = rng.randint(0, 10, (B, nmb, 18)).astype(np.uint8)
    return lv, meta8, esc_pos, esc_val, overflow, flags


@pytest.fixture(scope="module")
def wire_rows():
    """case -> (inputs, the port's rows, the JAX package's rows)."""
    out = {}
    for case in ("plain", "flags", "many_escapes"):
        lv, meta8, esc_pos, esc_val, overflow, flags = _wire_case(case)
        lv8 = np.clip(lv, -128, 127).astype(np.int8)
        args = (lv8, meta8, esc_pos, esc_val, overflow)
        got = W.wire_stage(*map(_t, args)).numpy()
        want = np.asarray(J._wire_stage(*map(jnp.asarray, args)))
        out[case] = (lv, args, flags), got, want
    return out


@pytest.mark.parametrize("case", ["plain", "flags", "many_escapes"])
def test_wire_stage_matches_jax(wire_rows, case):
    (lv, args, flags), got, want = wire_rows[case]
    nmb = lv.shape[1]
    assert got.dtype == np.uint8 and got.shape == (lv.shape[0], W.wire_bytes(nmb))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :2], flags)
    for b in range(len(got)):  # the last MB's escape is in the image list
        *_, eg_pos, eg_val = W.split_wire(got[b], nmb)
        last = np.flatnonzero(np.abs(lv[b, -1]) > 127)
        if not flags[b, 1]:
            assert set((nmb - 1) * 400 + last) <= set(eg_pos[eg_val != 0].tolist())


def _escape_oracle(esc_pos, esc_val):
    """The image escape list in integers: (positions, values, over)."""
    B, nmb, k = esc_pos.shape
    out = []
    for b in range(B):
        p = esc_pos[b].reshape(-1).astype(np.int64)
        sel = np.flatnonzero(p >= 0)
        pos = np.zeros(J.ESC_IMG, np.int64)
        val = np.zeros(J.ESC_IMG, np.int16)
        n = min(len(sel), J.ESC_IMG)
        pos[:n] = (sel[:n] // k) * 400 + p[sel[:n]]
        val[:n] = esc_val[b].reshape(-1)[sel[:n]]
        out.append((pos, val, len(sel) > J.ESC_IMG))
    return out


def test_escape_list_past_2_24_is_exact():
    """nmb = 45,000: positions up to 18e6 > 2^24.  The list through
    `escape_list` and through a whole wire row, unpacked on the host."""
    nmb = 45_000
    rng = np.random.RandomState(6)
    lv = np.zeros((1, nmb, 400), np.int32)
    mbs = np.concatenate([rng.choice(nmb, 40, replace=False), np.arange(nmb - 12, nmb)])
    for m in mbs:
        lv[0, m, rng.choice(400, rng.randint(1, 5), replace=False)] = rng.choice([-1, 1]) * 700
    big = np.abs(lv[0]) > 127
    esc_pos = np.full((1, nmb, J.N_ESC), -1, np.int16)
    esc_val = np.zeros((1, nmb, J.N_ESC), np.int16)
    for m in np.flatnonzero(big.any(-1)):
        at = np.flatnonzero(big[m])
        esc_pos[0, m, :len(at)] = at
        esc_val[0, m, :len(at)] = lv[0, m, at]
    pos, val, over = W.escape_list(_t(esc_pos), _t(esc_val))
    (want_pos, want_val, want_over), = _escape_oracle(esc_pos, esc_val)
    np.testing.assert_array_equal(pos[0].numpy(), want_pos)
    np.testing.assert_array_equal(val[0].numpy(), want_val)
    assert not over[0] and not want_over and want_pos.max() > 2 ** 24
    assert (want_pos % 2 == 1).any()  # odd positions: float32 cannot hold them past 2^24

    lv8 = np.clip(lv, -128, 127).astype(np.int8)
    meta8 = np.zeros((1, nmb, 18), np.uint8)
    row = W.wire_stage(*map(_t, (lv8, meta8, esc_pos, esc_val, np.zeros(1, bool))))[0].numpy()
    assert not row[:2].any()
    got = W.unpack_wire(row, nmb)
    np.testing.assert_array_equal(
        np.concatenate([got["y_levels"].reshape(nmb, 256), got["uv_levels"].reshape(nmb, 128),
                        got["y2_levels"]], axis=1), lv[0])


def test_escape_list_matches_rank_compact_at_1536():
    nmb = 1536
    rng = np.random.RandomState(7)
    esc_pos = np.full((2, nmb, J.N_ESC), -1, np.int16)
    esc_val = np.zeros((2, nmb, J.N_ESC), np.int16)
    for b, n_mbs in ((0, 120), (1, 600)):  # image 1: over ESC_IMG
        for m in rng.choice(nmb, n_mbs, replace=False):
            k = rng.randint(1, J.N_ESC + 1)
            esc_pos[b, m, :k] = np.sort(rng.choice(400, k, replace=False))
            esc_val[b, m, :k] = rng.choice([-1, 1], k) * rng.randint(128, 32768, k)
    pos, val, over = W.escape_list(_t(esc_pos), _t(esc_val))
    gpos = (np.arange(nmb, dtype=np.int32)[None, :, None] * 400
            + esc_pos.astype(np.int32)).reshape(2, -1)
    (jpos, jval), jover = J._rank_compact(
        jnp.asarray((esc_pos >= 0).reshape(2, -1)), J.ESC_IMG,
        (jnp.asarray(gpos), jnp.asarray(esc_val.reshape(2, -1).astype(np.int32) & 0xFFFF)))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos).astype(np.int32))
    np.testing.assert_array_equal(val.numpy(), np.asarray(jval).astype(np.int32).astype(np.int16))
    np.testing.assert_array_equal(over.numpy(), np.asarray(jover))
    assert over.tolist() == [False, True]
    for b, (p, v, o) in enumerate(_escape_oracle(esc_pos, esc_val)):
        np.testing.assert_array_equal(pos[b].numpy(), p)


def _dense(arrays):
    nmb = arrays["luma_mode"].shape[0]
    return np.concatenate([arrays["y_levels"].reshape(nmb, 256),
                           arrays["uv_levels"].reshape(nmb, 128), arrays["y2_levels"]], axis=1)


@pytest.mark.parametrize("case", ["plain", "flags"])
def test_unpack_matches_jax(wire_rows, case):
    (lv, (lv8, meta8, *_), flags), got, _ = wire_rows[case]
    nmb = lv.shape[1]
    for b in range(len(got)):
        dense = W.unpack_dense_wire(lv8[b], got[b], nmb)
        want = J.unpack_analysis_dense_wire(lv8[b], got[b], nmb)
        pairs = [(dense, want)]
        if not flags[b].any():
            pairs.append((W.unpack_wire(got[b], nmb), J.unpack_analysis_wire(got[b], nmb)))
        for g, w in pairs:
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            if not flags[b, 1]:
                np.testing.assert_array_equal(_dense(g), lv[b])
            np.testing.assert_array_equal(g["bpred"], meta8[b, :, :16])


def test_native_expand_matches_numpy_and_refuses(wire_rows):
    (lv, *_), got, _ = wire_rows["plain"]
    nmb = lv.shape[1]
    for b in range(len(got)):
        _, _, bitmap, vals4, med_idx, med_val, *_ = W.split_wire(got[b], nmb)
        a = native.wire_expand_levels(bitmap, vals4, med_idx, med_val, nmb)
        assert a.dtype == np.int16
        np.testing.assert_array_equal(a, W.numpy_wire_expand(bitmap, vals4, med_idx, med_val, nmb))
        np.testing.assert_array_equal(a, np.clip(lv[b], -128, 127))
    _, _, bitmap, vals4, med_idx, med_val, *_ = W.split_wire(got[0], nmb)
    with pytest.raises(ValueError, match="cap_mb"):  # the C++ holds 512 values an MB
        native.wire_expand_levels(bitmap, np.zeros((nmb, 257), np.uint8), med_idx, med_val, nmb,
                                  cap_mb=513)
    with pytest.raises(ValueError, match="cap_mb"):
        native.wire_expand_levels(bitmap, np.zeros((nmb, 257), np.uint8), med_idx, med_val, nmb)
    bad = med_idx.copy(), med_val.copy()
    m = int(np.flatnonzero(np.unpackbits(bitmap).reshape(nmb, 400).sum(1) == 5)[0])
    bad[0][m, 0], bad[1][m, 0] = 5, 20  # a med entry at rank 5 of an MB of 5 nonzeros
    with pytest.raises(ValueError, match="-3"):
        native.wire_expand_levels(bitmap, vals4, *bad, nmb)
    (_, *_), over_rows, _ = wire_rows["flags"]
    _, _, bitmap, vals4, med_idx, med_val, *_ = W.split_wire(over_rows[0], nmb)
    with pytest.raises(ValueError, match="-1"):  # an MB over CAP_MB: the dense row's case
        native.wire_expand_levels(bitmap, vals4, med_idx, med_val, nmb)


def _frames():
    """[flat saturated 16x16 tiles (a Y2 DC past 127 in every MB), seeded
    noise (MBs over CAP_MB nonzeros and MED_CAP med entries)]."""
    w, h = FRAME
    yy, xx = np.mgrid[0:h, 0:w]
    tiles = np.repeat(np.where(((yy // 16) + (xx // 16)) % 2 == 1, 255, 0)[..., None], 3, 2)
    noise = 128 + np.random.RandomState(8).randint(-40, 41, (h, w, 3))
    return [tiles.astype(np.uint8), np.clip(noise, 0, 255).astype(np.uint8)]


@pytest.fixture(scope="module")
def slice_rows():
    """tables -> (the port's (lv8, wire), the JAX package's) at Q100 m3."""
    w, h = FRAME
    mbw, mbh = w // 16, h // 16
    planes = edev.rgb_to_planes(_frames())
    y, u, v = edev.upload(planes, "cpu")
    P, _ = edev.params_for(None, QUALITY, "cpu")
    default = EncTables.from_probs(T.COEFF_PROBS_DEFAULT)
    totals, ones = edev.encode_analysis_stats_batch(y, u, v, P, default, 3)
    probs = edev.adapt_probs(totals.numpy(), ones.numpy())
    Y, U, V = (jnp.asarray(p) for p in planes)
    JP = JEncParams(JSegmentParams(jqi(QUALITY)))
    out = {}
    for name, tbl, jtbl, fn in (
            ("shared", default, JEncTables.default(), J.encode_analysis_batch_v2_packed),
            ("per_image", edev.tables_for(probs, "cpu"),
             J.enc_tables_from_probs(jnp.asarray(probs)), J.encode_analysis_batch_v2_pertbl_packed)):
        lv8, wire, _ = W.encode_analysis_batch_packed(y, u, v, P, tbl, 3)
        want = fn(Y, U, V, JP, jtbl, mbw, mbh, 3, False, None)
        out[name] = (lv8.numpy(), wire.numpy()), tuple(np.asarray(a) for a in want)
    return out


@pytest.mark.parametrize("tables", ["shared", "per_image"])
def test_packed_analysis_matches_jax(slice_rows, tables):
    (lv8, wire), (jlv8, jwire) = slice_rows[tables]
    np.testing.assert_array_equal(lv8, jlv8)
    np.testing.assert_array_equal(wire, jwire)
    nmb = lv8.shape[1]
    *_, eg_pos, eg_val = W.split_wire(wire[0], nmb)
    assert (eg_val != 0).sum() >= nmb and (np.abs(eg_val[eg_val != 0]) > 127).all()
    assert wire[:, 0].tolist() == [0, 1] and not wire[:, 1].any()  # image 1: sp_over


@pytest.mark.parametrize("two_pass", [True, False], ids=["two_pass", "one_pass"])
def test_payloads_through_the_wire_match_jax(two_pass):
    frames = _frames()
    before = dict(edev.WIRE_BRANCHES)
    got = webp_tpu_torch.encode_frames_lossy_batch(frames, QUALITY, 3, two_pass, device="cpu")
    taken = {k: edev.WIRE_BRANCHES[k] - before[k] for k in before}
    assert taken == {"sparse": 1, "dense_row": 1, "dense_arrays": 0}
    assert got == jvp8.encode_frames_lossy_batch(frames, QUALITY, 3, two_pass)


def test_wire_inputs_drive_every_branch():
    """The seeded overflow arrays of `wire_inputs.py` (chip_smoke's overflow
    case): each image's flags, and `fetch_packed` returning the arrays
    exactly through each branch: the dense arrays when the batch holds an
    image with 5 escapes in an MB (or over ESC_IMG); without those images,
    the sparse rows and the dense int8 rows (sp_over), unpacked lazily."""
    arrays, lv, flags = wire_arrays(5, 200, 10)
    dev_arrays = {k: _t(a) for k, a in arrays.items()}
    pre = W.prepack(dev_arrays)
    rows = W.wire_stage(*pre)
    np.testing.assert_array_equal(rows[:, :2].numpy(), flags)
    assert flags.tolist() == [[0, 0], [1, 0], [1, 0], [0, 1], [0, 1]]
    want = edev.fetch(dev_arrays)
    keep = [0, 1, 2]  # no overflowing escape list
    sub = {k: t[keep] for k, t in dev_arrays.items()}
    pre_sub = W.prepack(sub)
    for a, rows_, branch in ((dev_arrays, rows, "dense_arrays"),
                             (sub, W.wire_stage(*pre_sub), "dense_row")):
        before = dict(edev.WIRE_BRANCHES)
        got = edev.fetch_packed(W.prepack(a)[0], rows_, a)
        assert all(isinstance(g, edev.LazyUnpack) for g in got) == (branch == "dense_row")
        got = pickle.loads(pickle.dumps(got))  # as a worker process returns them: plain dicts
        for i, g in enumerate(got):
            for k in want[i]:
                np.testing.assert_array_equal(g[k], want[i][k], err_msg=k)
            np.testing.assert_array_equal(_dense(g), lv[i])
        taken = {k: edev.WIRE_BRANCHES[k] - before[k] for k in before}
        assert taken[branch] == (5 if branch == "dense_arrays" else 2)

"""K18 (prepack), K19 (per-MB level pack) and their fused launch: the
kernels' lane-per-run schedule on the CPU, against the plain twins and the
JAX package.

`prepack_runs_plain`, `pack_levels_runs_plain` and `prepack_pack_runs_plain`
below walk the schedule of `webp_tpu_torch/csrc/wire.cu` (kept here, beside
its tests, since no caller of the package needs it): a warp per MB, run r =
slots 8r..8r+7, pass A lane L taking run L and pass B lane L < 18 taking
run 32 + L; a run's levels loaded as one 16-byte load (K19: 8 bytes),
clipped to int8 and written to lv8 as one 8-byte store; each lane's
pass-A count in the low half of a word and its pass-B count in the high
half, one five-round `__shfl_up_sync` scan of that word giving every run
its exclusive base (pass B's plus pass A's total); K18's escape ranks from
those bases, its padding (-1 / 0) past the MB's escapes; K19's bitmap byte
per run (slot 8r at bit 7), its nonzeros scattered at their ranks into a
zeroed per-warp tile and the tile copied out (16-byte chunks when cap % 16
== 0, else bytes); the fused kernel K18's runs handed to K19 in registers.
They are held to `prepack_plain`, `pack_levels_mb_plain` and
`prepack_pack_plain` (and the wrappers' CPU paths) and to the JAX
package's `device_pack_levels_mb` (`webp_tpu/ops/sparse.py:73`), on
`wire_inputs.py`'s arrays (every flag: an MB over CAP_MB nonzeros, over
MED_CAP med entries, over N_ESC escapes, four escapes in every MB) at nmb
1, 7 and 1,536, caps 256 and 100.  A mutated schedule (a pass-B run one
lane off, an inclusive scan, a tile left unzeroed) fails a case.
Tolerance: bit-exact (integer arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.ops.sparse import device_pack_levels_mb
from webp_tpu_torch.ops import wire
from webp_tpu_torch.ops.sparse import pack_levels_mb, pack_levels_mb_plain
from webp_tpu_torch.ops.wire import CAP_MB, N_ESC, SLOTS

from wire_inputs import wire_arrays

LANES = 32
RUNS = SLOTS // 8  # 50
RUNS_B = RUNS - LANES  # 18: pass B's lanes
MUTATIONS = ("run_off", "inclusive_scan", "unzeroed_tile")


def run_of(pass_: int, lane: torch.Tensor, mutation=None) -> torch.Tensor:
    """The run that lane `lane` takes in pass 0 (A) or 1 (B); -1: none.
    The "run_off" mutation loads pass B's runs one lane off (the stores
    keep the right map)."""
    if pass_ == 0:
        return lane
    off = 1 if mutation == "run_off" else 0
    r = LANES + lane + off
    return torch.where((lane < RUNS_B) & (r < RUNS), r, -1)


def lane_runs(x: torch.Tensor, mutation=None) -> torch.Tensor:
    """[..., 400] per MB -> [..., 2, 32, 8]: each (pass, lane)'s run as it
    loads it, zero where the lane takes none."""
    runs = x.reshape(*x.shape[:-1], RUNS, 8)
    out = torch.zeros((*x.shape[:-1], 2, LANES, 8), dtype=x.dtype)
    lane = torch.arange(LANES)
    for p in (0, 1):
        r = run_of(p, lane, mutation)
        out[..., p, r >= 0, :] = runs[..., r[r >= 0], :]
    return out


def _shfl_up_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan over the last dim (32 lanes) in five __shfl_up_sync
    rounds: lane l adds lane l - d's value where l >= d."""
    x = x.clone()
    for d in (1, 2, 4, 8, 16):
        x[..., d:] = x[..., d:] + x[..., :-d].clone()
    return x


def run_bases(counts: torch.Tensor, mutation=None, trace=None) -> torch.Tensor:
    """counts [..., 2, 32] (pass, lane), at most 8 each -> each run's base
    rank: the lanes' words count_a | count_b << 16, one scan; pass B's
    bases add pass A's total."""
    word = counts[..., 0, :] | (counts[..., 1, :] << 16)
    incl = _shfl_up_scan(word)
    base = incl if mutation == "inclusive_scan" else incl - word
    total_a = incl[..., -1:] & 0xFFFF
    bases = torch.stack([base & 0xFFFF, total_a + (base >> 16)], dim=-2)
    if trace is not None:
        trace["bases"] = bases
        trace["total"] = total_a[..., 0] + (incl[..., -1] >> 16)
    return bases


def ranks_in_run(mask: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """mask [..., 8] of a run's slots -> the rank of each set slot (its
    run's base plus the set slots before it in the run)."""
    return bases[..., None] + torch.cumsum(mask.to(torch.int64), -1) - mask.to(torch.int64)


def store8(rows: torch.Tensor, runs8: torch.Tensor) -> torch.Tensor:
    """The lanes' 8-byte stores of their int8 runs [..., 2, 32, 8] into the
    rows int8 [..., 400], one int64 word a run."""
    words = rows.view(torch.int64)  # [..., 50]
    packed = runs8.contiguous().view(torch.int64)[..., 0]  # [..., 2, 32]
    lane = torch.arange(LANES)
    for p in (0, 1):
        r = run_of(p, lane)
        words[..., r[r >= 0]] = packed[..., p, r >= 0]
    return rows


def _levels(arrays) -> torch.Tensor:
    B, nmb = arrays["luma_mode"].shape
    return torch.cat([arrays["y_levels"].reshape(B, nmb, 256),
                      arrays["uv_levels"].reshape(B, nmb, 128), arrays["y2_levels"]],
                     dim=-1).to(torch.int64)


def prepack_runs_plain(arrays, mutation=None, trace=None):
    """Twin of K18's schedule: (lv8, meta8, esc_pos, esc_val, over) as
    `prepack_plain`, and the lanes' int8 runs [B, nmb, 2, 32, 8]."""
    B, nmb = arrays["luma_mode"].shape
    raw = lane_runs(_levels(arrays), mutation)  # the 16-byte loads
    runs8 = raw.clamp(-128, 127).to(torch.int8)
    esc = raw.abs() > 127
    lv8 = store8(torch.zeros((B, nmb, SLOTS), dtype=torch.int8), runs8)

    pos = torch.full((B, nmb, N_ESC), -1, dtype=torch.int16)
    val = torch.zeros((B, nmb, N_ESC), dtype=torch.int16)
    any_esc = esc.flatten(-3).any(-1)  # the warp's ballot
    bases = run_bases(esc.sum(-1), mutation, trace)
    rank = ranks_in_run(esc, bases)
    lane = torch.arange(LANES)
    slot0 = torch.stack([8 * run_of(0, lane), 8 * run_of(1, lane)])[..., None] + torch.arange(8)
    put = esc & (rank < N_ESC) & any_esc[..., None, None, None]
    b, m, p, ln, i = put.nonzero(as_tuple=True)
    pos[b, m, rank[put]] = slot0[p, ln, i].to(torch.int16)
    val[b, m, rank[put]] = raw[put].to(torch.int16)
    total = bases[..., 1, -1] + esc[..., 1, -1, :].sum(-1)  # the last run's end
    over = (total > N_ESC).any(-1)
    meta8 = torch.cat([arrays["bpred"], arrays["luma_mode"][..., None],
                       arrays["chroma_mode"][..., None]], dim=-1).to(torch.uint8)
    return (lv8, meta8, pos, val, over), runs8


def pack_runs(runs8: torch.Tensor, cap: int, mutation=None, trace=None):
    """Twin of K19's schedule on the lanes' int8 runs [B, nmb, 2, 32, 8]:
    (bitmap, vals, over)."""
    B, nmb = runs8.shape[:2]
    nz = runs8 != 0
    bits = (nz.to(torch.int32) << (7 - torch.arange(8, dtype=torch.int32))).sum(-1)
    bitmap = torch.zeros((B, nmb, RUNS), dtype=torch.uint8)
    lane = torch.arange(LANES)
    for p in (0, 1):
        r = run_of(p, lane)
        bitmap[..., r[r >= 0]] = bits[..., p, r >= 0].to(torch.uint8)
    bases = run_bases(nz.sum(-1), mutation, trace)
    rank = ranks_in_run(nz, bases)
    chunks = -(-cap // 16)
    if mutation == "unzeroed_tile":  # what an earlier warp left in shared memory
        g = torch.Generator().manual_seed(cap)
        tile = torch.randint(-128, 128, (B, nmb, 16 * chunks), generator=g, dtype=torch.int8)
    else:
        tile = torch.zeros((B, nmb, 16 * chunks), dtype=torch.int8)
    put = nz & (rank < cap)
    b, m = put.nonzero(as_tuple=True)[:2]
    tile[b, m, rank[put]] = runs8[put]
    if cap % 16 == 0:  # 16-byte chunks
        vals = tile.view(B, nmb, chunks, 16)[:, :, : cap // 16].reshape(B, nmb, cap)
    else:
        vals = tile[..., :cap].clone()
    total = bases[..., 1, -1] + nz[..., 1, -1, :].sum(-1)
    return bitmap.reshape(B, nmb * RUNS), vals, (total > cap).any(-1)


def pack_levels_runs_plain(lv8: torch.Tensor, cap: int, mutation=None, trace=None):
    """Twin of K19 alone: the lanes' 8-byte loads of lv8, then its pack."""
    return pack_runs(lane_runs(lv8, mutation), cap, mutation, trace)


def prepack_pack_runs_plain(arrays, mutation=None):
    """Twin of the fused kernel: K18's schedule, then K19's pack at CAP_MB
    on K18's runs (in registers on the card)."""
    pre, runs8 = prepack_runs_plain(arrays, mutation)
    return (*pre, *pack_runs(runs8, CAP_MB, mutation))


CASES = [(1, 40), (7, 41), (1536, 42)]  # (nmb, seed), batch 5: every case of wire_inputs.py


@pytest.fixture(scope="module", params=CASES, ids=[f"nmb{n}" for n, _ in CASES])
def case(request):
    nmb, seed = request.param
    arrays_h, lv, flags = wire_arrays(5, nmb, seed)
    return {k: torch.from_numpy(a) for k, a in arrays_h.items()}, lv, flags


def _equal(got, want, names):
    for g, w, name in zip(got, want, names):
        assert g.dtype == w.dtype and tuple(g.shape) == tuple(w.shape), name
        assert torch.equal(g, w), name


PRE = ("lv8", "meta8", "esc_pos", "esc_val", "overflow")
PACK = ("bitmap", "vals", "sp_over")


def test_prepack_runs_match_plain(case):
    arrays, lv, _ = case
    got, _ = prepack_runs_plain(arrays)
    _equal(got, wire.prepack_plain(arrays), PRE)
    _equal(got, wire.prepack(arrays), PRE)
    # the escapes, in slot order, as the levels hold them
    B, nmb = lv.shape[:2]
    for b in range(B):
        for m in range(nmb):
            at = np.flatnonzero(np.abs(lv[b, m]) > 127)
            n = min(len(at), N_ESC)
            assert got[2][b, m, :n].tolist() == at[:n].tolist()
            assert got[3][b, m, :n].tolist() == lv[b, m, at[:n]].tolist()
            assert (got[2][b, m, n:] == -1).all() and (got[3][b, m, n:] == 0).all()


@pytest.mark.parametrize("cap", [256, 100])
def test_pack_runs_match_plain_and_jax(case, cap):
    arrays, _, _ = case
    lv8 = wire.prepack_plain(arrays)[0]
    got = pack_levels_runs_plain(lv8, cap)
    _equal(got, pack_levels_mb_plain(lv8, cap), PACK)
    _equal(got, pack_levels_mb(lv8, cap), PACK)
    B, nmb, _ = lv8.shape
    chunk = 64  # the JAX one-hot matmul per chunk of MBs: [B, chunk, 400, cap] floats
    parts = [device_pack_levels_mb(jnp.asarray(lv8[:, i:i + chunk].numpy()), cap)
             for i in range(0, nmb, chunk)]
    want = (np.concatenate([np.asarray(p[0]) for p in parts], axis=1),
            np.concatenate([np.asarray(p[1]) for p in parts], axis=1),
            np.any([np.asarray(p[2]) for p in parts], axis=0))
    for g, w, name in zip(got, want, PACK):
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_fused_runs_match_plain(case):
    arrays, _, flags = case
    got = prepack_pack_runs_plain(arrays)
    want = wire.prepack_pack_plain(arrays)
    _equal(got, want, PRE + PACK)
    _equal(got, wire.prepack_pack(arrays), PRE + PACK)
    _equal(want[5:], pack_levels_mb_plain(wire.prepack_plain(arrays)[0], CAP_MB), PACK)
    assert got[7].tolist() == [False, True, False, False, False]  # case 1: over CAP_MB
    assert got[4].tolist() == [False, False, False, True, False]  # case 3: over N_ESC
    rows = wire.wire(*got[5:], *got[1:5])
    np.testing.assert_array_equal(rows[:, :2].numpy(), flags)


def test_run_map_covers_each_run_once():
    """Pass A's 32 lanes and pass B's first 18 take runs 0..49, each once;
    a run's 8 levels sit at 8r in lv8 (an 8-byte aligned word)."""
    lane = torch.arange(LANES)
    runs = torch.cat([run_of(0, lane), run_of(1, lane)])
    assert sorted(runs[runs >= 0].tolist()) == list(range(RUNS))
    assert (run_of(1, lane) >= 0).sum() == RUNS_B == 18
    x = torch.arange(SLOTS)
    got = lane_runs(x)
    assert torch.equal(got[0].reshape(-1), x[:256])
    assert torch.equal(got[1, :RUNS_B].reshape(-1), x[256:])
    assert not got[1, RUNS_B:].any()


def test_scan_bases_are_exclusive_in_run_order(case):
    """The packed two-half scan gives run r the count of the runs before it
    (pass A's then pass B's), for the nonzeros and for the escapes."""
    arrays, _, _ = case
    for trace_of, counts_of in (
            (lambda t: prepack_runs_plain(arrays, trace=t), lambda lv: (lv.abs() > 127)),
            (lambda t: pack_levels_runs_plain(wire.prepack_plain(arrays)[0], CAP_MB, trace=t),
             lambda lv: lv.clamp(-128, 127) != 0)):
        trace = {}
        trace_of(trace)
        per_run = counts_of(_levels(arrays)).reshape(*arrays["luma_mode"].shape, RUNS, 8).sum(-1)
        want = torch.cumsum(per_run, -1) - per_run
        got = torch.cat([trace["bases"][..., 0, :], trace["bases"][..., 1, :RUNS_B]], dim=-1)
        assert torch.equal(got, want)
        assert torch.equal(trace["total"], per_run.sum(-1))


@pytest.mark.parametrize("mutation", MUTATIONS)
def test_mutated_schedule_fails(mutation):
    """Each mutation breaks K18, K19 or the fused kernel on some case."""
    failed = []
    for nmb, seed in CASES[:2]:
        arrays_h, _, _ = wire_arrays(5, nmb, seed)
        arrays = {k: torch.from_numpy(a) for k, a in arrays_h.items()}
        lv8 = wire.prepack_plain(arrays)[0]
        pairs = [(prepack_pack_runs_plain(arrays, mutation), wire.prepack_pack_plain(arrays))]
        if mutation != "unzeroed_tile":
            pairs.append((prepack_runs_plain(arrays, mutation)[0], wire.prepack_plain(arrays)))
        for cap in (256, 100):
            pairs.append((pack_levels_runs_plain(lv8, cap, mutation),
                          pack_levels_mb_plain(lv8, cap)))
        failed += [not all(torch.equal(g, w) for g, w in zip(got, want)) for got, want in pairs]
    assert any(failed)

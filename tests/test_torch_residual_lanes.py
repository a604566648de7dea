"""K1 (levels -> residuals): the kernel's partition on the CPU, against the
plain twins and the JAX package.

`residuals_lanes_plain` below walks the kernel's schedule (kept here,
beside its tests, since no caller of the package needs it): CTAs of
WARPS = 8 consecutive MBs of an image (the kernel's kWarps), one warp an
MB (the ragged tail's warps leave), lane k < 25 owning block k; the
lanes' rank bases from a shuffle scan of their bitmap pairs' popcounts;
each warp's 32-ary search of the image's escape list and its MB's run
read 32 entries at a time, each entry applied by the lane that owns its
block; lane 24's IWHT handed to lanes 0-15; the store through the
swizzled tile. It is held to `residuals_sparse_plain` /
`residuals_dense_plain` (and, through the wrappers, to the CPU path) and
to `_decode_core`'s levels -> residuals half (copied line for line, with
the JAX package's own functions), on host-encoded frames (with forced
escapes) and on `lane_inputs.py`'s cases: escape runs across CTA edges
and longer than a warp, a list of 4,096 used entries with no sentinel,
MBs at and past `cap`, 15 MBs (not a multiple of 8).
Tolerance: bit-exact (integer arithmetic).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.ops import jax_ops
from webp_tpu.ops.sparse import device_expand_levels_mb
from webp_tpu_torch.decode import device as tdev
from webp_tpu_torch.ops import residual
from webp_tpu_torch.ops.residual import SLOTS, WARPS
from webp_tpu_torch.ops.transform import idct4x4, iwht4x4

from lane_inputs import K1_CASES, k1_case
from torch_fixtures import force_escapes, mixed_payloads

FIELDS = ("segment_ids", "luma_mode", "skipped", "non_zero")
SPARSE = ("bitmap", "vals", "esc_pos", "esc_val", "qtab")


def _shfl_up_scan(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan over the last dim (32 lanes) in the kernel's five
    __shfl_up_sync rounds: lane l adds lane l - d's value where l >= d."""
    x = x.clone()
    for d in (1, 2, 4, 8, 16):
        x[..., d:] = x[..., d:] + x[..., :-d].clone()
    return x


def _swizzle(c: torch.Tensor) -> torch.Tensor:
    """The kernel's shared-tile chunk of logical chunk c."""
    return (c & ~7) | ((c + (c >> 3)) & 7)


def residuals_lanes_plain(seg, lmode, skipped, non_zero, sparse=None, i16buf=None, trace=None):
    """Twin of the K1 kernel's partition (CPU): CTAs of WARPS consecutive
    MBs of an image, one warp an MB (the run's ragged tail's warps leave),
    lane k < 25 owning block k.  `sparse` = (bitmap, vals, esc_pos, esc_val,
    qtab), else `i16buf` the dense levels then qtab.  Sparse: each lane's
    16-bit bitmap pair, its first rank from a shuffle scan of the
    popcounts, its values at those ranks of the MB's row (0 at or past
    cap); each warp's 32-ary lower bound of m*400 in the image's escape
    list (a probe a lane a round), then its MB's run 32 entries at a
    time, broadcast in lane order, each applied by the lane that owns its
    block.  Then dequant, lane 24's IWHT handed to lanes 0-15 where the MB
    is not B-predicted, every lane's IDCT, and the store through the
    swizzled tile.  Same outputs as `residuals_*_plain`.  Where `trace`
    is a dict it receives per (image, MB) the search's rounds, the lanes'
    rank bases and the run (first entry, end)."""
    B, nmb = seg.shape
    ctas = -(-nmb // WARPS)
    m = (torch.arange(ctas)[:, None] * WARPS + torch.arange(WARPS)).reshape(-1)
    m = m[m < nmb]
    W = m.numel()
    lane = torch.arange(32)
    bw = (torch.arange(B)[:, None].expand(B, W), torch.arange(W).expand(B, W))
    lv = torch.zeros((B, W, 32, 16), dtype=torch.int32)
    if sparse is not None:
        bitmap, vals, esc_pos, esc_val, qtab = (a.cpu() for a in sparse)
        bm = bitmap.reshape(B, nmb, SLOTS // 8)[:, m].to(torch.int32)
        bits = torch.zeros((B, W, 32), dtype=torch.int32)
        bits[..., :25] = (bm[..., 0::2] << 8) | bm[..., 1::2]
        bit = (bits[..., None] >> (15 - torch.arange(16))) & 1
        count = bit.sum(-1)
        base = _shfl_up_scan(count) - count
        rank = base[..., None] + torch.cumsum(bit, -1) - bit
        cap = vals.shape[-1]
        v = vals[:, m].to(torch.int32)
        picked = torch.gather(v, 2, rank.clamp(0, cap - 1).reshape(B, W, -1)).reshape(rank.shape)
        lv = torch.where((bit == 1) & (rank < cap), picked, 0).to(torch.int32)

        n_esc = esc_pos.shape[-1]
        pos = esc_pos.to(torch.int64)
        lo_pos, hi_pos = (m * SLOTS).expand(B, W), (m * SLOTS + SLOTS).expand(B, W)
        lo = torch.zeros((B, W), dtype=torch.int64)
        hi = torch.full((B, W), n_esc, dtype=torch.int64)
        rounds = torch.zeros((B, W), dtype=torch.int64)
        while bool((lo < hi).any()):
            act = lo < hi
            step = (hi - lo + 31) >> 5
            probe = lo[..., None] + (lane + 1) * step[..., None] - 1
            inside = probe < hi[..., None]
            got = torch.gather(pos, 1, probe.clamp(0, max(n_esc - 1, 0)).reshape(B, -1))
            ge = ~inside | (got.reshape(B, W, 32) >= lo_pos[..., None])
            found = ge.any(-1)
            f = ge.to(torch.int64).argmax(-1)
            new_lo = torch.where(found, lo + f * step, hi)
            new_hi = torch.where(found, torch.minimum(lo + (f + 1) * step - 1, hi), hi)
            lo, hi = torch.where(act, new_lo, lo), torch.where(act, new_hi, hi)
            rounds += act
        start, live = lo.clone(), torch.ones((B, W), dtype=torch.bool)
        while n_esc and bool(live.any()):
            i = start[..., None] + lane
            ok = i < n_esc
            ic = i.clamp(max=n_esc - 1).reshape(B, -1)
            p = torch.where(ok, torch.gather(pos, 1, ic).reshape(B, W, 32), hi_pos[..., None])
            inn = live[..., None] & (p < hi_pos[..., None])
            e = torch.gather(esc_val.to(torch.int32), 1, ic).reshape(B, W, 32)
            for src in range(32):  # the broadcasts, in lane order
                sel = inn[..., src]
                slot = p[..., src] - lo_pos
                lv[bw[0][sel], bw[1][sel], slot[sel] >> 4, slot[sel] & 15] = e[..., src][sel]
            start += 32
            live &= inn.all(-1) & (start < n_esc)
        if trace is not None:
            for b in range(B):
                for w in range(W):
                    end = int(torch.searchsorted(pos[b], int(hi_pos[b, w])))
                    trace[(b, int(m[w]))] = {"rounds": int(rounds[b, w]),
                                             "rank_base": base[b, w, :25].tolist(),
                                             "run": (int(lo[b, w]), max(end, int(lo[b, w])))}
    else:
        i16buf = i16buf.cpu()
        lv[..., :25, :] = i16buf[:, : nmb * SLOTS].reshape(B, nmb, 25, 16)[:, m].to(torch.int32)
        qtab = i16buf[:, nmb * SLOTS:]

    s = seg.cpu()[:, m].to(torch.int64)
    q = qtab.reshape(B, 4, 25, 16).to(torch.int32)[bw[0], s]
    lv[..., :25, :] *= q
    lm = lmode.cpu()[:, m].to(torch.int32)
    dc = iwht4x4(lv[..., 24, :])  # lane 24's, taken by lanes 0-15
    lv[..., :16, 0] = torch.where((lm != 4)[..., None], dc, lv[..., :16, 0])
    lv = idct4x4(lv)
    tile = torch.zeros((B, W, 96, 4), dtype=torch.int32)
    tile[..., _swizzle(torch.arange(96)), :] = lv[..., :24, :].reshape(B, W, 96, 4)
    res = torch.full((B, nmb, 24, 16), -(2 ** 31), dtype=torch.int32)
    res[:, m] = tile[..., _swizzle(torch.arange(96)), :].reshape(B, W, 24, 16)
    do_sub = torch.zeros((B, nmb), dtype=torch.bool)
    do_sub[:, m] = (lm == 4) | (~skipped.cpu()[:, m].bool() & non_zero.cpu()[:, m].bool())
    return res, do_sub


def _jax_residuals(c, nmb, dense):
    """`_device_decode_sparse8`'s expand + escape scatter (or the dense
    levels), then `_decode_core`'s dequant / Y2 fold / IDCT / do_sub
    (webp_tpu/decode/device.py:540-552), copied line for line since
    `_decode_core` runs on to recon and the filter: a change there must be
    copied here.  test_torch_decode.py holds the port's whole decode to
    the JAX package's."""
    B = c["qtab"].shape[0]
    if dense:
        lv = jnp.asarray(c["i16buf"][:, : nmb * 400])
    else:
        lv = (device_expand_levels_mb(jnp.asarray(c["bitmap"]), jnp.asarray(c["vals"]), nmb, 400)
              .reshape(B, nmb * 400).astype(jnp.int16))
        lv = lv.at[jnp.arange(B)[:, None], jnp.asarray(c["esc_pos"])].set(
            jnp.asarray(c["esc_val"]), mode="drop")
    levels = lv.reshape(B, nmb, 25, 16)
    qtab = jnp.asarray(c["qtab"]).reshape(B, 4, 25, 16).astype(jnp.int32)
    sid = jnp.asarray(c["segment_ids"]).astype(jnp.int32)
    q = jnp.zeros((B, nmb, 25, 16), jnp.int32)
    for s in range(4):
        q = q + jnp.where((sid == s)[..., None, None], qtab[:, s][:, None], 0)
    deq = levels.astype(jnp.int32) * q
    y2 = jax_ops.iwht4x4(deq[:, :, 24, :])
    lm = jnp.asarray(c["luma_mode"]).astype(jnp.int32)
    dcs = jnp.where((lm != 4)[..., None], y2, deq[:, :, :16, 0])
    res = jax_ops.idct4x4(deq[:, :, :24, :].at[:, :, :16, 0].set(dcs))
    do_sub = (lm == 4) | (~jnp.asarray(c["skipped"]).astype(bool)
                          & jnp.asarray(c["non_zero"]).astype(bool))
    return np.asarray(res), np.asarray(do_sub)


def _encoded(forced):
    b = tdev.parse_levels_batch(mixed_payloads(72, 40, seeds=(11, 12)))
    if forced:
        b = force_escapes(b, count=40)
    nmb = b["u8buf"].shape[1] // 24
    c = {k: b[k] for k in SPARSE + ("i16buf",)}
    c.update({k: np.ascontiguousarray(v) for k, v in tdev.field_views(b["u8buf"], nmb).items()
              if k in FIELDS})
    c["nmb"] = nmb
    return c


CASES = {"encoded": lambda: _encoded(False), "forced_escapes": lambda: _encoded(True),
         **{name: (lambda name=name: k1_case(name)) for name in K1_CASES}}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return request.param, CASES[request.param]()


def _torch(c):
    return {k: torch.from_numpy(v) for k, v in c.items() if k != "nmb"}


@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense_int16"])
def test_lanes_match_plain_and_jax(case, dense):
    name, c = case
    t, nmb = _torch(c), c["nmb"]
    mb = [t[k] for k in FIELDS]
    if dense:
        got = residuals_lanes_plain(*mb, i16buf=t["i16buf"])
        want = residual.residuals_dense(t["i16buf"], *mb)
    else:
        got = residuals_lanes_plain(*mb, sparse=[t[k] for k in SPARSE])
        want = residual.residuals_sparse(*(t[k] for k in SPARSE), *mb)
    assert got[0].dtype == torch.int32 and tuple(got[0].shape) == (2, nmb, 24, 16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    jres, jds = _jax_residuals(c, nmb, dense)
    np.testing.assert_array_equal(got[0].numpy(), jres)
    np.testing.assert_array_equal(got[1].numpy(), jds)


def test_escape_search_and_runs(case):
    """Each warp's search ends at its MB's first entry, in at most
    ceil(log32(n_esc)) rounds; its run is the entries below (m + 1) * 400."""
    name, c = case
    t, nmb = _torch(c), c["nmb"]
    trace = {}
    residuals_lanes_plain(*(t[k] for k in FIELDS), sparse=[t[k] for k in SPARSE], trace=trace)
    n_esc = c["esc_pos"].shape[1]
    assert sorted(trace) == [(b, m) for b in range(2) for m in range(nmb)]
    runs = {}
    for (b, m), tr in trace.items():
        pos = c["esc_pos"][b]
        first = int(np.searchsorted(pos, m * 400))
        assert tr["run"][0] == first
        assert tr["rounds"] <= int(np.ceil(np.log(n_esc) / np.log(32)))
        runs[(b, m)] = tr["run"][1] - tr["run"][0]
        assert runs[(b, m)] == int(((pos >= m * 400) & (pos < m * 400 + 400)).sum())
    if name == "cta_edges":  # runs on both sides of the CTA edge, one past a warp
        assert runs[(0, 7)] and runs[(0, 8)] and runs[(0, 0)] and runs[(0, 14)]
        assert max(runs.values()) > 32
    if name == "full_list":
        assert n_esc == 4096 and (c["esc_pos"] < nmb * 400).all()
        assert max(tr["rounds"] for tr in trace.values()) == 3


def test_rank_bases_are_exclusive_popcount_scan(case):
    name, c = case
    t, nmb = _torch(c), c["nmb"]
    trace = {}
    residuals_lanes_plain(*(t[k] for k in FIELDS), sparse=[t[k] for k in SPARSE], trace=trace)
    bits = np.unpackbits(c["bitmap"], axis=1).reshape(2, nmb, 25, 16).sum(-1)
    for (b, m), tr in trace.items():
        want = np.concatenate([[0], np.cumsum(bits[b, m])[:-1]])
        np.testing.assert_array_equal(tr["rank_base"], want)
    if name == "at_cap":  # MB 4 and 14 hold more nonzeros than cap
        cap = c["vals"].shape[-1]
        assert bits[0, 0].sum() == cap and bits[0, 4].sum() > cap and bits[0, 14].sum() > cap

"""Kernel K20 (the wire rows, `webp_tpu_torch/csrc/wire.cu` `wire_kernel`):
the kernel's schedule on the CPU, against the plain twin and the JAX
package.

`wire_rows_plain` below walks the kernel's one schedule (kept here, beside
its tests, since no caller of the package needs it):

- a CTA of 8 warps per (32 consecutive MBs, image), a warp four MBs, lane
  L the run of packed values 8L..8L+7 of each (one 8-byte load), the
  bitmap and meta8 two bytes a lane;
- a lane's run -> 4 nibble bytes as one 32-bit word (`__byte_perm` of the
  masked words folded by 4 bits), its |v| > 7 slots (saturating |v|, so
  -128 counts) ranked in slot order from one five-round `__shfl_up_sync`
  scan a pair of MBs (2i, 2i + 1), their counts packed in 16-bit halves;
  entries below
  MED_CAP into zeroed med tiles;
- every contiguous piece of the CTA's MBs (bitmap, nibbles, med idx, med
  val, meta8) staged at the byte offset mod 16 that it has in the row
  (rows are modelled at their addresses from a 16-byte-aligned buffer, so
  image b's row starts at b * wire_bytes(nmb) mod 16) and copied out in
  16-byte chunks: a 16-byte store where the chunk lies inside the piece,
  else the widest aligned 8/4/2/1-byte stores that fit;
- a list CTA an image (x = 0 of the grid, beside the MB CTAs: it needs
  only the inputs) loads the image's (pos, val) pairs 1,024 MBs a round,
  4 consecutive MBs a thread (8 bytes each), ranks the live slots by one
  block scan of the threads' counts, writes the entries into a zeroed
  staged tile, copies the list out as above (no round once the list is
  over ESC_IMG) and stores the overflow flag byte; each MB CTA adds 1 to
  its image's ticket word (| 1 << 32 where an MB's med list is over its
  cap), and the one that completes the count stores the sp_over flag
  byte.

Every store is checked to be aligned to its width, and every byte of every
row to be written exactly once (no CTA writes a neighbour's bytes).  The
twin is held to `wire_plain` (and the wrapper's CPU path) and to the JAX
package's `_wire_stage` (`webp_tpu/ops/encode_wavefront2.py:1200`) on
`wire_inputs.py`'s arrays (every flag: an MB over CAP_MB nonzeros, over
MED_CAP med entries, over N_ESC escapes, an image over ESC_IMG) at nmb 1, 7
and 1,536 (JAX at 1 and 7: its one-hot pack at 1,536 would take gigabytes),
batch 5 (rows starting at 0, 2, 4, 6 and 8 mod 16 at nmb 1,536), also
with each MB's escape slots permuted so that holes (-1) lie between live
ones.  A mutated schedule (an inclusive scan, a piece staged one byte off
its head, the list ranked by slot instead of by the live mask) fails.
Tolerance: bit-exact (integer bytes).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.ops.encode_wavefront2 import _wire_stage
from webp_tpu_torch.ops import wire as W
from webp_tpu_torch.ops.wire import CAP_MB, ESC_IMG, MED_CAP, META, N_ESC, SLOTS, WIRE_MBS

from wire_inputs import wire_arrays

LANES, WARPS = 32, 8
BITMAP, NIB = SLOTS // 8, CAP_MB // 2
LIST_PER = 4  # MBs a thread of the list CTA loads a round
MUTATIONS = ("inclusive_scan", "head_off", "rank_by_position")
PIECES = (BITMAP, NIB, MED_CAP, MED_CAP, META)  # bytes an MB of each region, in row order


def shfl_up_scan(x: np.ndarray, width: int = LANES) -> np.ndarray:
    """Inclusive scan over the last axis in segments of `width` lanes, by
    `__shfl_up_sync` rounds: lane l adds lane l - d's value where l's
    index in its segment is at least d."""
    x = x.astype(np.int64).copy()
    idx = np.arange(x.shape[-1]) % width
    d = 1
    while d < width:
        up = np.zeros_like(x)
        up[..., d:] = x[..., :-d]
        x = np.where(idx >= d, x + up, x)
        d *= 2
    return x


class Row:
    """The output rows as one buffer at 16-byte-aligned address 0, with a
    count of the stores that reach each byte."""

    def __init__(self, nbytes: int, seed: int):
        self.buf = np.full(nbytes, 0xA5, np.uint8)
        self.hits = np.zeros(nbytes, np.int32)
        self.rng = np.random.RandomState(seed)

    def store(self, addr: int, data: np.ndarray) -> None:
        n = len(data)
        assert n in (1, 2, 4, 8, 16) and addr % n == 0, (addr, n)
        self.buf[addr:addr + n] = data
        self.hits[addr:addr + n] += 1

    def garbage(self, n: int) -> np.ndarray:
        """A staging buffer as shared memory holds it: what was there."""
        return self.rng.randint(0, 256, n).astype(np.uint8)

    def copy_out(self, dst: int, stage: np.ndarray, nbytes: int) -> None:
        """A staged piece (the byte at dst lies at stage[dst % 16]) out in
        16-byte chunks: whole chunks in one store, the ragged ones in the
        widest aligned stores that fit."""
        head = dst % 16
        a0 = dst - head
        for k in range((head + nbytes + 15) // 16):
            lo, hi = (head if k == 0 else 0), min(16, head + nbytes - 16 * k)
            g, s = a0 + 16 * k, stage[16 * k:16 * k + 16]
            if lo == 0 and hi == 16:
                self.store(g, s)
                continue
            while lo < hi:
                n = next(n for n in (8, 4, 2, 1) if lo % n == 0 and lo + n <= hi)
                self.store(g + lo, s[lo:lo + n])
                lo += n


def _words(b4: np.ndarray) -> np.ndarray:
    """[..., 4] uint8 -> little-endian uint32 [...]."""
    b4 = b4.astype(np.uint32)
    return b4[..., 0] | (b4[..., 1] << 8) | (b4[..., 2] << 16) | (b4[..., 3] << 24)


def lane_pieces(vals: np.ndarray, mutation=None):
    """Each MB's staged nibbles [B, nmb, 128], med idx and val tiles [B,
    nmb, 32] and med-over flags [B, nmb], as the lanes form them: a run
    per lane, each pair of a warp's MBs (m even, m odd: a CTA's first MB
    is even) ranked by one scan of their counts in 16-bit halves."""
    B, nmb, _ = vals.shape
    pad = -nmb % WIRE_MBS
    runs = np.concatenate([vals.view(np.uint8), np.zeros((B, pad, CAP_MB), np.uint8)], 1)
    runs = runs.reshape(B, nmb + pad, LANES, 8)
    a = _words(runs[..., :4]) & 0x0F0F0F0F
    c = _words(runs[..., 4:]) & 0x0F0F0F0F
    u, v = a | (a >> 4), c | (c >> 4)
    word = (u & 0xFF) | (((u >> 16) & 0xFF) << 8) | ((v & 0xFF) << 16) | (((v >> 16) & 0xFF) << 24)
    nib = word[..., None].view(np.uint8).reshape(B, nmb + pad, NIB)  # little-endian words

    hot = np.minimum(np.abs(runs.view(np.int8).astype(np.int32)), 127) > 7  # __vabsss4
    cnt = hot.sum(-1)  # [B, nmb + pad, 32]
    pair = cnt.reshape(B, -1, 2, LANES)
    packed = pair[:, :, 0] | (pair[:, :, 1] << 16)  # a warp's word per lane
    incl = shfl_up_scan(packed)
    ex = incl if mutation == "inclusive_scan" else incl - packed
    bases = np.stack([ex & 0xFFFF, ex >> 16], 2).reshape(B, -1, LANES)
    totals = np.stack([incl[..., -1] & 0xFFFF, incl[..., -1] >> 16], 2).reshape(B, -1)
    rank = bases[..., None] + np.cumsum(hot, -1) - hot
    mi = np.zeros((B, nmb + pad, MED_CAP), np.uint8)  # the zeroed tiles
    mv = np.zeros((B, nmb + pad, MED_CAP), np.uint8)
    put = hot & (rank < MED_CAP)
    b, m, lane, i = np.nonzero(put)
    mi[b, m, rank[put]] = (8 * lane + i).astype(np.uint8)
    mv[b, m, rank[put]] = runs[b, m, lane, i]
    return nib[:, :nmb], mi[:, :nmb], mv[:, :nmb], (totals > MED_CAP)[:, :nmb]


def live_count(pos: np.ndarray) -> np.ndarray:
    return (pos >= 0).sum(-1)


def image_list(esc_pos, esc_val, nmb, mutation=None):
    """The list CTA's list of one image: (tile bytes [3072], escapes seen):
    rounds of 1,024 MBs, thread t loading MBs 4t..4t+3 of the round (their
    positions and values, 8 bytes each), one block scan of the threads'
    live counts a round; no round once the list is over ESC_IMG."""
    tile = np.zeros(6 * ESC_IMG, np.uint8)
    pos_t = tile[:4 * ESC_IMG].view("<i4")
    val_t = tile[4 * ESC_IMG:].view("<i2")
    threads = WARPS * LANES
    carry, r0 = 0, 0
    while r0 < nmb and carry <= ESC_IMG:
        m = r0 + np.arange(threads * LIST_PER).reshape(threads, LIST_PER)
        inside = m < nmb
        p = np.where(inside[..., None], esc_pos[np.minimum(m, nmb - 1)], -1).astype(np.int64)
        v = np.where(inside[..., None], esc_val[np.minimum(m, nmb - 1)], 0).astype(np.int64)
        n = live_count(p).sum(-1)  # a thread's live escapes
        incl = np.cumsum(n)
        rank = carry + (incl if mutation == "inclusive_scan" else incl - n)
        for t in np.flatnonzero(n):
            r = rank[t]
            for q in range(LIST_PER):
                for e in range(N_ESC):
                    if p[t, q, e] >= 0:
                        at = r + e - (p[t, q, :e] >= 0).sum() if mutation == "rank_by_position" else r
                        if at < ESC_IMG:
                            pos_t[at] = m[t, q] * SLOTS + p[t, q, e]
                            val_t[at] = v[t, q, e]
                        r += 1
        carry += int(incl[-1])
        r0 += threads * LIST_PER
    return tile, carry


def wire_rows_plain(bitmap, vals, sp_over, meta8, esc_pos, esc_val, overflow, mutation=None,
                    seed=0):
    """Twin of K20's schedule: the wire rows uint8 [B, wire_bytes(nmb)] and
    the store count of each of their bytes."""
    B, nmb, _ = vals.shape
    row = W.wire_bytes(nmb)
    out = Row(B * row, seed)
    bitmap = bitmap.numpy().reshape(B, nmb, BITMAP)
    meta8, vals = meta8.numpy(), vals.numpy()
    esc_pos, esc_val = esc_pos.numpy(), esc_val.numpy()
    nib, mi, mv, med_over = lane_pieces(vals, mutation)
    per_mb = (bitmap, nib, mi, mv, meta8)
    n_cta = -(-nmb // WIRE_MBS)
    for b in range(B):
        med = False  # the ticket word's high half
        for c in range(n_cta):
            m0 = c * WIRE_MBS
            mbs = slice(m0, min(m0 + WIRE_MBS, nmb))
            n_mbs = mbs.stop - m0
            offset = 2
            for piece, per in zip(per_mb, PIECES):
                dst = b * row + offset + m0 * per
                head = dst % 16 + (1 if mutation == "head_off" else 0)
                stage = out.garbage(WIRE_MBS * per + 16)
                stage[head:head + n_mbs * per] = piece[b, mbs].reshape(-1)
                out.copy_out(dst, stage, n_mbs * per)
                offset += nmb * per
            med |= bool(med_over[b, mbs].any())
        tile, escapes = image_list(esc_pos[b], esc_val[b], nmb, mutation)
        dst = b * row + 2 + nmb * sum(PIECES)
        stage = np.zeros(6 * ESC_IMG + 16, np.uint8)
        stage[dst % 16:dst % 16 + 6 * ESC_IMG] = tile
        out.copy_out(dst, stage, 6 * ESC_IMG)
        out.store(b * row + 1, np.array([bool(overflow[b]) or escapes > ESC_IMG], np.uint8))
        out.store(b * row, np.array([bool(sp_over[b]) or med], np.uint8))  # the last MB CTA
    return torch.from_numpy(out.buf.reshape(B, row)), out.hits.reshape(B, row)


def with_holes(esc_pos: torch.Tensor, esc_val: torch.Tensor, seed: int):
    """Each MB's escape slots permuted (seeded): -1 holes between live ones."""
    g = torch.Generator().manual_seed(seed)
    perm = torch.argsort(torch.rand(esc_pos.shape, generator=g), -1)
    return esc_pos.gather(-1, perm), esc_val.gather(-1, perm)


CASES = [(1, 40), (7, 41), (1536, 42)]  # (nmb, seed), batch 5: every case of wire_inputs.py
B = 5


@functools.lru_cache(maxsize=None)
def make_case(nmb: int, seed: int) -> dict:
    arrays_h, _, flags = wire_arrays(B, nmb, seed)
    arrays = {k: torch.from_numpy(a) for k, a in arrays_h.items()}
    lv8, meta8, esc_pos, esc_val, over, bitmap, vals, sp_over = W.prepack_pack_plain(arrays)
    plain = (bitmap, vals.contiguous(), sp_over, meta8, esc_pos, esc_val, over)
    holes = with_holes(esc_pos, esc_val, seed)
    return {"nmb": nmb, "lv8": lv8, "flags": flags, "args": {
        False: plain, True: (*plain[:4], *holes, over)}}


@pytest.fixture(scope="module", params=CASES, ids=[f"nmb{n}" for n, _ in CASES])
def case(request):
    return make_case(*request.param)


@pytest.mark.parametrize("holes", [False, True], ids=["packed", "holes"])
def test_wire_rows_schedule_matches_plain(case, holes):
    args = case["args"][holes]
    got, hits = wire_rows_plain(*args)
    assert (hits == 1).all(), "a byte of a row written other than once"
    want = W.wire_plain(*args)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(got, W.wire(*args))  # the wrapper's CPU path
    if not holes:
        np.testing.assert_array_equal(got[:, :2].numpy(), case["flags"])


@pytest.mark.parametrize("holes", [False, True], ids=["packed", "holes"])
@pytest.mark.parametrize("nmb,seed", CASES[:2], ids=[f"nmb{n}" for n, _ in CASES[:2]])
def test_wire_rows_schedule_matches_jax(nmb, seed, holes):
    """Against `_wire_stage` at nmb 1 and 7 (its one-hot pack at 1,536 MBs
    would take gigabytes; that case is held to wire_plain above)."""
    c = make_case(nmb, seed)
    bitmap, vals, sp_over, meta8, esc_pos, esc_val, over = c["args"][holes]
    got, _ = wire_rows_plain(bitmap, vals, sp_over, meta8, esc_pos, esc_val, over)
    want = _wire_stage(*(jnp.asarray(t.numpy()) for t in (c["lv8"], meta8, esc_pos, esc_val,
                                                         over)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rows_start_off_16_bytes(case):
    """The layout the staging is for: at nmb 1,536 each region of a row
    starts at 2 mod 16 within it, and the batch's rows at 0, 2, 4, ... mod 16."""
    nmb, row = case["nmb"], W.wire_bytes(case["nmb"])
    starts = {b * row % 16 for b in range(B)}
    offsets = np.cumsum([2] + [nmb * p for p in PIECES])
    if nmb == 1536:
        assert starts == {0, 2, 4, 6, 8} and set(offsets % 16) == {2}
    else:
        assert len(starts) > 1


def test_list_over_cap_and_holes_rank_by_mask():
    """Four escapes in every MB of 200 (an image over ESC_IMG) with holes:
    the first 512 in (MB, k) order by the live mask; the flag set."""
    arrays_h, _, _ = wire_arrays(5, 200, 12)
    arrays = {k: torch.from_numpy(a) for k, a in arrays_h.items()}
    lv8, meta8, esc_pos, esc_val, over, bitmap, vals, sp_over = W.prepack_pack_plain(arrays)
    pos, val = with_holes(esc_pos, esc_val, 5)
    got, hits = wire_rows_plain(bitmap, vals.contiguous(), sp_over, meta8, pos, val, over)
    assert (hits == 1).all()
    assert torch.equal(got, W.wire_plain(bitmap, vals, sp_over, meta8, pos, val, over))
    assert got[4, 1] == 1  # case 4: 800 escapes
    *_, eg_pos, eg_val = W.split_wire(got[4].numpy(), 200)
    live = pos[4].numpy() >= 0
    mb = np.nonzero(live)[0]
    want = (mb * SLOTS + pos[4].numpy()[live])[:ESC_IMG]
    np.testing.assert_array_equal(eg_pos, want)


@pytest.mark.parametrize("mutation", MUTATIONS)
def test_mutated_schedule_fails(mutation):
    """Each mutation breaks the rows at nmb 7 with holes in the escape slots."""
    args = make_case(*CASES[1])["args"][True]
    got, hits = wire_rows_plain(*args, mutation=mutation)
    assert not (torch.equal(got, W.wire_plain(*args)) and (hits == 1).all())

"""K21 `pack_flat`'s single pass (`webp_tpu_torch/csrc/sparse.cu`
`pack_flat_kernel`) walked on the CPU, against the plain twin
`pack_levels_plain` and the JAX package's `device_pack_levels`.

`pack_flat_lookback_plain` below is the kernel's schedule: a few CTAs an
image (one a ticket, or fewer that loop), started in a seeded order, take
the image's tickets in turn until they run out; a ticket below the tile
count is a tile of slots, 32 a thread, the next ones the parts of the pad.
A tile's thread loads its levels (two 16-byte loads where its row starts
on 16 bytes and it holds 32 slots, else 8, 4 or 1 bytes at a time as the
row's alignment allows; the next tile's loads go out while the CTA looks
back on this one) and stores its bitmap bytes as one 4-byte word where
that is aligned, bytes otherwise; the CTA asks for its next ticket,
publishes its tile's count (tile 0 its inclusive prefix), stages its
nonzeros at their rank in the tile, looks back over the status words
before it a window at a time until it meets an inclusive prefix (reading a
window again while a tile before that prefix has not published),
publishes its own prefix and stores its staged values below the cap: bytes
at the head and tail of the run, 16-byte stores between.  A part of the
pad waits for the last tile's inclusive prefix (the image's count) and
zero-fills its share of the values past it (rounds of 16-byte stores dealt
in turn, the first part the bytes at the head and tail and the overflow
flag); the CTA that took the last part resets the image's tickets, done
count and status words once the image's other CTAs are done.  The CTAs'
steps interleave in a seeded order.  Every load and store is checked
aligned to its width, every level read once, every output byte (bitmap,
values, flag) written exactly once, and the state left zero.  Inputs:
`tests/sparse_inputs.py` (densities 0 to 1, exactly at the cap, over it,
+-127 and -128), at N and at N - 8 (N % 16 = 8, N % 32 != 0), at the
kernel's tile, window and pad share and at short ones (many tiles, many
windows, several pad parts), at aligned and misaligned row bases, with 1,
2, 3 or a CTA a ticket, at the case's cap, at cap 0, at an odd cap and at
exactly and one under the largest count.  A look-back that skips one
predecessor, and a pad written before the image's last tile has published
(after tile 0's prefix), must fail.  Tolerance: 0 (integers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.ops import sparse as J
from webp_tpu_torch.ops import sparse as S

from sparse_inputs import flat_cases

CASES = ("density_0", "density_0.05", "density_0.23", "density_0.31", "density_1", "at_cap",
         "over_cap", "extremes")
AGGREGATE, PREFIX = 1, 2
# (tile slots, look-back window, pad bytes a part, B, nmb): the kernel's
# (`csrc/sparse.cu` kTileSlots, 32 * kLook, kPadBytes), and short ones.
SHAPES = [(S.FLAT_TILE, 128, 32768, 2, 100), (256, 4, 512, 3, 8), (512, 2, 2048, 2, 40)]
MAX_PADS = 8  # kMaxPads
# Byte offsets from a 16-byte boundary of (the levels, the bitmap, the values).
BASES = [(0, 0, 0), (8, 3, 5), (4, 1, 15), (3, 2, 9)]
# CTAs an image: one a ticket (the kernel's when the card holds them all), one
# that takes every ticket, and a few that loop.
CTAS = (1 << 30, 1, 2, 3)


def _load_widths(addr: int, valid: int):
    """A thread's loads (address, width) of its `valid` levels at `addr`."""
    if valid == 32 and addr % 16 == 0:
        return [(addr, 16), (addr + 16, 16)]
    out = []
    for a in range(addr, addr + valid, 8):
        if a % 8 == 0:
            out.append((a, 8))
        elif a % 4 == 0:
            out += [(a, 4), (a + 4, 4)]
        else:
            out += [(a + i, 1) for i in range(8)]
    return out


class _Memory:
    """A byte array whose every store is checked aligned to its width and
    counted per byte."""

    def __init__(self, size: int):
        self.data = np.zeros(size + 16, np.int16)
        self.count = np.zeros(size + 16, np.int32)

    def store(self, at: int, values, width: int):
        assert at % width == 0, f"a {width}-byte store off its alignment"
        assert len(values) == width
        self.data[at:at + width] = values
        self.count[at:at + width] += 1

    def span(self, dst: int, values, part: int = 0, parts: int = 1, threads: int = 1):
        """The kernel's `store_span` by CTA `part` of `parts`: bytes up to
        dst's first 16-byte boundary and past its last (part 0), 16-byte
        stores between, `threads` a round, the parts' rounds dealt in turn."""
        length = len(values)
        head = min(length, (16 - dst % 16) % 16)
        chunks = (length - head) // 16
        for k in range(chunks):
            if (k // threads) % parts == part:
                at = head + 16 * k
                self.store(dst + at, values[at:at + 16], 16)
        if part == 0:
            for at in list(range(head)) + list(range(head + 16 * chunks, length)):
                self.store(dst + at, values[at:at + 1], 1)

    def once(self, base: int, size: int) -> bool:
        c = self.count
        return bool((c[base:base + size] == 1).all() and not c[:base].any()
                    and not c[base + size:].any())


def pads_of(cap: int, pad_bytes: int) -> int:
    """The pad's parts an image (`csrc/sparse.cu` pads_of)."""
    return min(MAX_PADS, max(1, -(-cap // pad_bytes)))


def pack_flat_lookback_plain(flat: np.ndarray, cap: int, tile: int, window: int, pad_bytes: int,
                             ctas: int, seed: int, bases=(0, 0, 0), skip: bool = False,
                             early_pad: bool = False):
    """The kernel's CTAs as generators, `ctas` an image (at most its
    tickets), stepped in a seeded order; (bitmap uint8 [B, N/8], vals int8
    [B, cap], over bool [B], the state words left behind).  `bases`: the
    byte offsets of the levels, the bitmap and the values from a 16-byte
    boundary.  Mutations: `skip`, the look-back starts one tile too far
    back; `early_pad`, the pad's parts take tile 0's inclusive prefix for
    the image's count."""
    B, N = flat.shape
    nb = N // 8
    in_base, bm_base, v_base = bases
    ntiles = -(-N // tile)
    pads = pads_of(cap, pad_bytes)
    items = ntiles + pads
    ctas = min(ctas, items)
    threads = tile // 32
    ticket = np.zeros(B, np.int64)
    done = np.zeros(B, np.int64)
    status = np.zeros((B, ntiles, 2), np.int64)  # (flag, value)
    read = np.zeros((B, N), np.int32)
    bm, vm, om = _Memory(bm_base + B * nb), _Memory(v_base + B * cap), _Memory(B)
    rng = np.random.RandomState(seed)

    def take(b):
        t = int(ticket[b])
        ticket[b] += 1
        return t

    def load(b, t):
        """Tile t's loads, each checked aligned to its width and counted."""
        first = t * tile
        for tid in range(threads):
            valid = max(0, min(32, N - first - 32 * tid))
            addr = in_base + b * N + first + 32 * tid
            for a, width in _load_widths(addr, valid):
                assert a % width == 0, f"a {width}-byte load off its alignment"
                read[b, a - in_base - b * N:a - in_base - b * N + width] += 1
        return t

    def pad_part(b, part):
        last = 0 if early_pad else ntiles - 1
        while status[b, last, 0] != PREFIX:
            yield  # the image's count not published yet
        count = int(status[b, last, 1])
        if part == 0:
            om.store(b, [int(count > cap)], 1)
        if count < cap:
            vm.span(v_base + b * cap + count, np.zeros(cap - count, np.int16), part, pads,
                    threads)

    def tile_work(b, t, loaded):
        """Tile t (its levels `loaded`); returns the next ticket."""
        assert loaded == t
        nxt = take(b) if ctas < items else items  # the next ticket, asked for first
        first = t * tile
        levels = flat[b, first:first + tile].astype(np.int16)
        length = len(levels)
        bits = levels != 0
        counts = np.zeros(threads, np.int64)
        for tid in range(threads):  # 1. the bitmap words, the block scan
            mine = 32 * tid
            valid = max(0, min(32, length - mine))
            packed = np.packbits(bits[mine:mine + valid]).astype(np.int16)
            dst = bm_base + b * nb + (first + mine) // 8
            if valid == 32 and dst % 4 == 0:
                bm.store(dst, packed, 4)
            else:
                for q in range(valid // 8):
                    bm.store(dst + q, packed[q:q + 1], 1)
            counts[tid] = bits[mine:mine + valid].sum()
        total = int(counts.sum())
        # 2. The count published; the staging: a slot's rank in the tile is
        #    the block scan's prefix of its thread plus the set slots before
        #    it in the thread.
        status[b, t] = (PREFIX if t == 0 else AGGREGATE, total)
        before = np.cumsum(counts) - counts
        within = np.concatenate([np.cumsum(bits[m:m + 32]) - bits[m:m + 32]
                                 for m in range(0, length, 32)])
        rank = np.repeat(before, 32)[:length] + within
        staged = np.zeros(tile, np.int16)
        assert np.array_equal(np.sort(rank[bits]), np.arange(total))
        staged[rank[bits]] = levels[bits]
        yield
        loaded = load(b, nxt) if nxt < ntiles else None  # the next tile's loads
        excl = 0  # the look-back, a window a round
        if t > 0:
            end = t - 1 if skip else t
            while True:
                js = end - 1 - np.arange(window)
                s = [tuple(status[b, j]) if j >= 0 else (PREFIX, 0) for j in js]
                flags = [f for f, _ in s]
                stop = flags.index(PREFIX) if PREFIX in flags else window - 1
                if 0 in flags[:stop + 1]:
                    yield  # a tile before the prefix has not published
                    continue
                excl += sum(v for _, v in s[:stop + 1])
                if PREFIX in flags:
                    break
                end -= window
                yield
        status[b, t] = (PREFIX, excl + total)
        yield
        # 3. The values below the cap.
        vm.span(v_base + b * cap + min(excl, cap), staged[:max(0, min(total, cap - excl))])
        return nxt, loaded

    def cta(b):
        t = take(b)
        loaded = load(b, t) if t < ntiles else None
        last = False
        yield
        while t < items:
            if t >= ntiles:
                yield from pad_part(b, t - ntiles)
                last = t == items - 1
                t = take(b)
            else:
                t, loaded = yield from tile_work(b, t, loaded)
            yield
        if not last:
            done[b] += 1
            return
        while done[b] != ctas - 1:
            yield  # the CTA of the last part resets the words once the others are done
        status[b] = 0
        ticket[b] = 0
        done[b] = 0

    pending = [b for b in range(B) for _ in range(ctas)]
    rng.shuffle(pending)  # the order CTAs start (and take tickets) in
    running = []
    while pending or running:
        if pending and (not running or rng.rand() < 0.3):
            running.append(cta(pending.pop()))
        k = rng.randint(len(running))
        try:
            next(running[k])
        except StopIteration:
            running.pop(k)
    if not (read == 1).all():
        raise AssertionError("a level read other than once")
    for mem, base, size in ((bm, bm_base, B * nb), (vm, v_base, B * cap), (om, 0, B)):
        if not mem.once(base, size):
            raise AssertionError("an output byte written other than once")
    bitmap = bm.data[bm_base:bm_base + B * nb].astype(np.uint8).reshape(B, nb)
    vals = vm.data[v_base:v_base + B * cap].astype(np.int8).reshape(B, cap)
    return bitmap, vals, om.data[:B] != 0, (ticket, done, status)


def _want(flat: np.ndarray, cap: int):
    """The plain twin's pack, checked equal to the JAX package's."""
    want = [t.numpy() for t in S.pack_levels_plain(torch.from_numpy(flat), cap)]
    got = [np.asarray(a) for a in J.device_pack_levels(jnp.asarray(flat), cap)]
    for w, g in zip(want, got):
        assert np.array_equal(w, g.astype(w.dtype))
    return want


def _check(flat, cap, shape, ctas, seed, bases=(0, 0, 0)):
    want = _want(flat, cap)
    tile, window, pad_bytes = shape[:3]
    *got, (ticket, done, status) = pack_flat_lookback_plain(flat, cap, tile, window, pad_bytes,
                                                            ctas, seed, bases)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w), (tile, cap, bases)
    assert not ticket.any() and not done.any() and not status.any()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"tile{s[0]}_window{s[1]}")
@pytest.mark.parametrize("name", CASES)
def test_lookback_twin_matches_plain_and_jax(name, shape):
    """At N and N - 8, the case's cap, at every base."""
    *_, B, nmb = shape
    flat, cap = flat_cases(B, nmb, nmb)[name]
    N = flat.shape[1]
    assert N % 16 == 0
    for n in (N, N - 8):
        assert n % 16 == (0 if n == N else 8) and (n == N or n % 32 != 0)
        for seed, (bases, ctas) in enumerate(zip(BASES, CTAS)):
            _check(np.ascontiguousarray(flat[:, :n]), cap, shape, ctas, n + seed, bases)


@pytest.mark.parametrize("cap_of", ["zero", "odd", "count", "count_less_1"])
@pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda s: f"tile{s[0]}_window{s[1]}")
def test_lookback_twin_caps(shape, cap_of):
    """Cap 0 (every value dropped, the flag set where any is nonzero), an
    odd cap (rows of values off 16 bytes), a cap of exactly the largest
    image's count and one less (that image alone over it)."""
    *_, B, nmb = shape
    flat, cap = flat_cases(B, nmb, nmb + 1)["density_0.23"]
    most = int((flat != 0).sum(1).max())
    cap = {"zero": 0, "odd": cap // 3 + 7, "count": most, "count_less_1": most - 1}[cap_of]
    for seed, (bases, ctas) in enumerate(zip(BASES[:2], CTAS[1:])):
        _check(flat, cap, shape, ctas, cap + seed, bases)


def test_lookback_twin_single_tile():
    """One tile an image: no look-back, the tile is the image's last."""
    flat, cap = flat_cases(3, 8, 5)["over_cap"]
    assert -(-flat.shape[1] // S.FLAT_TILE) == 1
    for ctas in CTAS:
        _check(flat, cap, SHAPES[0], ctas, ctas, (3, 2, 9))


@pytest.mark.parametrize("mutation", ["skip", "early_pad"])
def test_lookback_mutations_break(mutation):
    """A look-back that skips a predecessor, or pad parts that take tile 0's
    prefix for the image's count, give other values or write a byte twice."""
    flat, cap = flat_cases(3, 8, 6)["density_0.23"]
    want = _want(flat, cap)
    try:
        *got, _ = pack_flat_lookback_plain(flat, cap, 256, 4, 512, 3, seed=3,
                                           **{mutation: True})
    except AssertionError:
        return
    assert not all(np.array_equal(g, w) for g, w in zip(got, want))

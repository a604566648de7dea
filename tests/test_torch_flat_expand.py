"""K22 `expand_flat`'s single pass (`webp_tpu_torch/csrc/sparse.cu`
`expand_flat_kernel`) walked on the CPU, against the plain twin
`expand_levels_plain` and the JAX package's `device_expand_levels`.

`expand_flat_lookback_plain` below is the kernel's schedule: a CTA per tile
of slots of one image, 32 slots a thread; CTAs start in a seeded order and
take their tiles by the image's ticket; each publishes its tile's count
(tile 0 its inclusive prefix), looks back over the status words before it a
window at a time until it meets an inclusive prefix (reading a window again
while a tile before that prefix has not published), publishes its own
prefix, stages the span of values its ranks take (each at most cap - 1) at
their address mod 16, and stores its bytes: two 16-byte stores a thread on
a row that starts and ends on 16 bytes, else through a shared tile, bytes at
the head and tail and 16-byte stores between.  The CTAs' steps interleave
in a seeded order.  Every store is checked aligned to its width, every
output byte written exactly once, and the status words, tickets and done
counts left zero by each image's last CTA.  Inputs: `tests/sparse_inputs.py`
(densities 0 to 1, exactly at the cap, over it, +-127 and -128) packed by
the JAX package, expanded at n = N and N - 5 from a bitmap with bytes past
ceil(n / 8) (nb > ceil(n / 8), random bits there), at the kernel's tile and
window and at short ones (many tiles, many windows), at aligned and
misaligned output bases.  A look-back that skips one predecessor must fail.
Tolerance: 0 (integers).
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
EXTRA_BYTES = 5  # bitmap bytes past the N slots, random
AGGREGATE, PREFIX = 1, 2
# (tile slots, look-back window, B, nmb): the kernel's, and short ones.
SHAPES = [(S.FLAT_TILE, 128, 2, 100), (256, 4, 3, 8), (512, 2, 2, 40)]


def expand_flat_lookback_plain(bitmap: np.ndarray, vals: np.ndarray, n: int, tile: int,
                               window: int, seed: int, out_base: int = 0, skip: bool = False):
    """The kernel's CTAs as generators, stepped in a seeded order;
    (out int8 [B, n], the state words left behind).  `out_base`: the
    output's byte offset from a 16-byte aligned address.  `skip` (a
    mutation): the look-back starts one tile too far back."""
    B, nb = bitmap.shape
    cap = vals.shape[1]
    ntiles = -(-n // tile)
    threads = tile // 32
    ticket = np.zeros(B, np.int64)
    done = np.zeros(B, np.int64)
    status = np.zeros((B, ntiles, 2), np.int64)  # (flag, value)
    mem = np.zeros(out_base + B * n + 16, np.int16)
    written = np.zeros(out_base + B * n + 16, np.int32)
    rng = np.random.RandomState(seed)

    def slot_bits(b, first):
        """The tile's slots as bits, bytes at or past nb read as 0, slots at
        or past n as 0."""
        byte0 = first // 8
        row = np.zeros(tile // 8, np.uint8)
        have = max(0, min(nb - byte0, tile // 8))
        row[:have] = bitmap[b, byte0:byte0 + have]
        bits = np.unpackbits(row).astype(np.int64)
        bits[max(0, n - first):] = 0
        return bits

    def cta(b):
        t = int(ticket[b])  # 1. the ticket, then the bitmap and the block scan
        ticket[b] += 1
        yield
        first = t * tile
        bits = slot_bits(b, first)
        counts = bits.reshape(threads, 32).sum(1)
        total = int(counts.sum())
        status[b, t] = (PREFIX if t == 0 else AGGREGATE, total)
        yield
        excl = 0  # 2. the look-back, a window a round
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
        # 3. The value span, staged at its address mod 16 (the row of image b
        #    starts at byte b * cap of an aligned allocation).
        lo = min(excl, cap - 1)
        lead = (b * cap + lo) % 16
        staged = np.zeros(tile + 16, np.int16)
        if total > 0:
            hi = min(excl + total - 1, cap - 1)
            staged[lead:lead + hi - lo + 1] = vals[b, lo:hi + 1]
        rank = excl + np.cumsum(bits) - bits
        out = np.where(bits == 1, staged[np.minimum(rank, cap - 1) - lo + lead], 0)
        # 4. The stores.
        dst = out_base + b * n + first
        length = min(tile, n - first)
        if (out_base + b * n) % 16 == 0 and n % 16 == 0:
            for tid in range(threads):
                for half in (0, 16):
                    at = 32 * tid + half
                    if at < length:
                        assert (dst + at) % 16 == 0, "a 16-byte store off its alignment"
                        mem[dst + at:dst + at + 16] = out[at:at + 16]
                        written[dst + at:dst + at + 16] += 1
        else:
            head = min(length, (16 - dst % 16) % 16)
            chunks = (length - head) // 16
            for k in range(chunks):
                at = head + 16 * k
                assert (dst + at) % 16 == 0, "a 16-byte store off its alignment"
                mem[dst + at:dst + at + 16] = out[at:at + 16]
                written[dst + at:dst + at + 16] += 1
            for at in list(range(head)) + list(range(head + 16 * chunks, length)):
                mem[dst + at] = out[at]
                written[dst + at] += 1
        yield
        done[b] += 1  # 5. the image's last CTA resets its words
        if done[b] == ntiles:
            status[b] = 0
            ticket[b] = 0
            done[b] = 0

    pending = [(x, b) for b in range(B) for x in range(ntiles)]
    rng.shuffle(pending)  # the order CTAs start (and take tickets) in
    running = []
    while pending or running:
        if pending and (not running or rng.rand() < 0.3):
            _, b = pending.pop()
            running.append(cta(b))
        k = rng.randint(len(running))
        try:
            next(running[k])
        except StopIteration:
            running.pop(k)
    body = written[out_base:out_base + B * n]
    if not (body == 1).all() or written[:out_base].any() or written[out_base + B * n:].any():
        raise AssertionError("an output byte written other than once")
    out = mem[out_base:out_base + B * n].astype(np.int8).reshape(B, n)
    return out, (ticket, done, status)


def _packed(name: str, B: int, nmb: int):
    """The JAX package's pack of the case, the bitmap widened by
    EXTRA_BYTES random bytes an image."""
    flat, cap = flat_cases(B, nmb, nmb)[name]
    bitmap, vals, _ = (np.array(a) for a in J.device_pack_levels(jnp.asarray(flat), cap))
    extra = np.random.RandomState(nmb).randint(0, 256, (B, EXTRA_BYTES)).astype(np.uint8)
    return flat, np.concatenate([bitmap, extra], 1), vals


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"tile{s[0]}_window{s[1]}")
@pytest.mark.parametrize("name", CASES)
def test_lookback_twin_matches_plain_and_jax(name, shape):
    tile, window, B, nmb = shape
    flat, bitmap, vals = _packed(name, B, nmb)
    N = flat.shape[1]
    assert bitmap.shape[1] > -(-N // 8)
    for n in (N, N - 5):
        want = S.expand_levels_plain(torch.from_numpy(bitmap), torch.from_numpy(vals), n).numpy()
        jax_out = np.asarray(J.device_expand_levels(jnp.asarray(bitmap), jnp.asarray(vals), n))
        assert np.array_equal(want, jax_out)
        for seed, out_base in ((n, 0), (n + 1, 3)):
            got, (ticket, done, status) = expand_flat_lookback_plain(bitmap, vals, n, tile,
                                                                    window, seed, out_base)
            assert np.array_equal(got, want), (n, seed, out_base)
            assert not ticket.any() and not done.any() and not status.any()
        if n == N:
            within = (flat != 0).sum(1) <= vals.shape[1]
            assert np.array_equal(got[within], flat[within])


def test_lookback_twin_single_tile_and_span_across_the_cap():
    """One tile an image (no look-back), and a tile whose value span
    crosses the cap (its ranks past cap - 1 repeat the last value)."""
    flat, bitmap, vals = _packed("over_cap", 2, 8)
    n = flat.shape[1]
    want = S.expand_levels_plain(torch.from_numpy(bitmap), torch.from_numpy(vals), n).numpy()
    got, _ = expand_flat_lookback_plain(bitmap, vals, n, S.FLAT_TILE, 32, seed=1)
    assert -(-n // S.FLAT_TILE) == 1 and np.array_equal(got, want)
    got, _ = expand_flat_lookback_plain(bitmap, vals, n, 256, 4, seed=2)
    assert np.array_equal(got, want)


def test_lookback_skipping_a_predecessor_breaks():
    flat, bitmap, vals = _packed("density_0.23", 3, 8)
    n = flat.shape[1]
    want = S.expand_levels_plain(torch.from_numpy(bitmap), torch.from_numpy(vals), n).numpy()
    got, _ = expand_flat_lookback_plain(bitmap, vals, n, 256, 4, seed=3, skip=True)
    assert not np.array_equal(got, want)

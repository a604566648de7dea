"""K11 `color_indexing`'s partition (`webp_tpu_torch/csrc/vp8l.cu`
`color_indexing_kernel`) walked on the CPU, against the plain twin
`color_indexing_plain` and the JAX package's `color_indexing`.

`color_indexing_runs_plain` below is the kernel's schedule in torch: a CTA
per (image, run of `index_rows` rows) loads the image's palette once; its
threads take the items (row, group) of the run in the order tid + 256 k,
stepped without a division; a group is 4 output pixels (8 at 8 indices a
byte) on the output's 16-byte lattice, so a row whose first word lies m
words past an aligned address starts its lattice at x = -m.  A group wholly
in its row stores 16 bytes at a time, the groups at a row's head and tail 4
bytes a pixel; a group whose packed words are aligned reads them in one
load (16, 8 or 4 bytes), others 4 bytes a pixel.  Memory is a flat word
array with the tensors placed at word offsets, so that misaligned bases are
walked too: every store is checked aligned to its width and every output
word written exactly once.  Seeded inputs: table sizes 1-256 (every
packing), widths 1-767, heights 1-9, batch 2, indices past the table size
(transparent black).  Tolerance: 0 (integers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.ops import vp8l_device as J
from webp_tpu_torch.ops import vp8l_device as K

TABLE_SIZES = (1, 2, 3, 4, 5, 16, 17, 200, 256)
WIDTHS = (1, 3, 4, 7, 8, 9, 29, 33, 767)
HEIGHTS = (1, 2, 9)
BATCH = 2
# (output, packed input) word offsets from a 16-byte aligned address.
BASES = ((0, 0), (1, 0), (3, 2))


def _words(px: np.ndarray) -> np.ndarray:
    """uint8 [..., 4] RGBA -> uint32 words, R in the low byte."""
    return np.ascontiguousarray(px).view(np.uint32)[..., 0]


def color_indexing_runs_plain(px: torch.Tensor, table: torch.Tensor, table_size: int,
                              width: int, out_base: int = 0, px_base: int = 0,
                              head_short: bool = False) -> torch.Tensor:
    """K11's CTAs, threads and stores in order; the output [B, h, width, 4].
    `out_base` / `px_base`: the tensors' word offsets from an aligned
    address.  `head_short` (a mutation) takes every row's lattice one word
    too late."""
    B, h, pw = px.shape[:3]
    wbits = K.pack_bits(table_size)
    G, Q, bits = (8, 1, 1) if wbits == 3 else (4, 4 >> wbits, 8 >> wbits)
    mem_px = np.zeros(px_base + B * h * pw, np.uint32)
    mem_px[px_base:] = _words(px.numpy()).reshape(-1)
    mem_out = np.zeros(out_base + B * h * width, np.uint32)
    written = np.zeros(out_base + B * h * width, np.int32)
    tab = _words(table.numpy())  # [B, 256]
    rows = K.index_rows(width, h)
    threads = K.INDEX_THREADS
    even = width % 4 == 0 and out_base % 4 == 0
    ng = -(-width // G) if even else -(-(width + 3) // G)

    def index(word, x):
        green = (int(word) >> 8) & 0xFF
        return (green >> ((x & ((1 << wbits) - 1)) * bits)) & ((1 << bits) - 1)

    for b in range(B):
        for r0 in range(0, h, rows):
            palette = tab[b]  # loaded once a CTA, a word a thread
            items = min(rows, h - r0) * ng
            step_rows, step_g = threads // ng, threads % ng
            for tid in range(threads):
                row, g = tid // ng, tid % ng
                for it in range(tid, items, threads):
                    img_row = b * h + r0 + row
                    m = (img_row * width + out_base) % 4
                    if head_short:
                        m = (m + 1) % 4
                    x0 = g * G - m
                    p = px_base + img_row * pw + (x0 >> wbits)  # the group's packed words
                    vec_load = m == 0 and x0 + G <= width and p % Q == 0
                    if vec_load:
                        q = mem_px[p:p + Q]
                        v = [palette[index(q[j * Q // G], j)] for j in range(G)]
                    else:
                        v = [palette[index(mem_px[px_base + img_row * pw + ((x0 + j) >> wbits)],
                                           x0 + j)] if 0 <= x0 + j < width else 0
                             for j in range(G)]
                    o = out_base + img_row * width + x0
                    if 0 <= x0 and x0 + G <= width:  # 16-byte stores
                        for j in range(0, G, 4):
                            assert (o + j) % 4 == 0, "a 16-byte store off its alignment"
                            mem_out[o + j:o + j + 4] = v[j:j + 4]
                            written[o + j:o + j + 4] += 1
                    else:
                        for j in range(G):
                            if 0 <= x0 + j < width:
                                mem_out[o + j] = v[j]
                                written[o + j] += 1
                    g += step_g
                    row += step_rows
                    if g >= ng:
                        g -= ng
                        row += 1
    if not (written[out_base:] == 1).all():
        raise AssertionError("an output word written other than once")
    out = mem_out[out_base:].reshape(B, h, width).view(np.uint8).reshape(B, h, width, 4)
    return torch.from_numpy(out.copy())


def _inputs(table_size: int, width: int, h: int, seed: int):
    """Seeded packed pixels (indices up to 255: past the table too) and a
    palette zero past table_size."""
    rng = np.random.RandomState(seed)
    pw = K.subsample(width, K.pack_bits(table_size))
    px = rng.randint(0, 256, (BATCH, h, pw, 4)).astype(np.uint8)
    table = np.zeros((BATCH, 256, 4), np.uint8)
    table[:, :table_size] = rng.randint(0, 256, (BATCH, table_size, 4))
    return torch.from_numpy(px), torch.from_numpy(table)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("table_size", TABLE_SIZES)
def test_index_runs_match_plain_and_jax(table_size, width):
    for h in HEIGHTS:
        px, table = _inputs(table_size, width, h, seed=1000 * table_size + 10 * width + h)
        want = K.color_indexing_plain(px, table, table_size, width)
        jax_out = np.asarray(J.color_indexing(jnp.asarray(px.numpy()), jnp.asarray(table.numpy()),
                                              table_size, width))
        assert np.array_equal(want.numpy(), jax_out)
        for out_base, px_base in BASES:
            got = color_indexing_runs_plain(px, table, table_size, width, out_base, px_base)
            assert torch.equal(got, want), (h, out_base, px_base)


@pytest.mark.parametrize("table_size", [2, 12, 200])
def test_index_runs_cta_shape(table_size):
    """At the main path's width a CTA takes 8 rows (24 KB out) and its 256
    threads 6 groups of 4 pixels (3 of 8 at 8 indices a byte) each."""
    assert K.index_rows(768, 512) == 8 and K.index_rows(768, 5) == 5
    assert K.index_rows(8192, 512) == 1 and K.index_rows(1, 9) == 9
    G = 8 if K.pack_bits(table_size) == 3 else 4
    assert 8 * -(-768 // G) / K.INDEX_THREADS == (3 if G == 8 else 6)


def test_index_runs_mutation_breaks():
    """A lattice one word late stores across its alignment or leaves a head
    word unwritten: the twin refuses it."""
    px, table = _inputs(12, 29, 9, seed=5)
    with pytest.raises(AssertionError):
        color_indexing_runs_plain(px, table, 12, 29, head_short=True)

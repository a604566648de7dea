"""Kernels K16 and K17: reconstruction and loop filter with each image's MB
rows split into bands.

Replace `webp_tpu/parallel/pipeline.py:60` `decode_wavefront_banded` and
`:37` `_band_shifts`, which shard the rows over the mesh's `band` axis and
exchange boundary rows between neighbour devices with `ppermute` at every
wavefront step.  On the card a band is one CTA of a thread-block cluster
(`csrc/banded.cu`): K16 `recon_banded_` and K17 `filter_banded_` compute
K2's and K3's planes, byte for byte, with the band's rows run as row
pipelines of one warp (pipeline g takes the band's rows g, g + G, ...),
gated by progress counters in shared memory; a band's first row reads the
counter of the band above's last row through distributed shared memory.

The plain twins keep the JAX form: each band's rows are a tensor of their
own with halo rows above, and at every step `band_shift` hands each band
its neighbour's boundary rows, down for the recon row above and the
filter's 4 margin rows, up for the 3 rows the filter writes back into the
band above; a band with no neighbour gets zeros, and the frame's edges
come from the global MB row.  The MB work per diagonal is K2's and K3's
twins' (`wavefront.recon_mbs_`, `loopfilter.filter_mbs_`).  The schedule
twins `recon_banded_rows_plain_` and `filter_banded_rows_plain_` (tests
only) walk the kernels' own schedule, MB by MB, in seeded orders that the
counters allow.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from .loopfilter import filter_mbs_, filter_params
from .recon_filter import WAIT, RowSteps
from .wavefront import _bordered, diagonal, recon_mbs_

MAX_BANDS = 8  # the portable cluster size


def check_bands(n_band: int, mbh: int = None) -> int:
    """`n_band` if it is 1..MAX_BANDS and divides `mbh` (when given), else
    ValueError."""
    if not isinstance(n_band, int) or not 1 <= n_band <= MAX_BANDS:
        raise ValueError(f"n_band must be an int in 1..{MAX_BANDS}, got {n_band!r}")
    if mbh is not None and mbh % n_band:
        raise ValueError(f"n_band {n_band} does not divide the {mbh} MB rows")
    return n_band


def band_shift(rows, direction: str):
    """Per band, its neighbour's `rows` (a list of one tensor per band):
    band k gets band k-1's (direction "down") or band k+1's ("up"), and the
    band without that neighbour zeros."""
    zero = torch.zeros_like(rows[0])
    if direction == "down":
        return [zero] + list(rows[:-1])
    if direction == "up":
        return list(rows[1:]) + [zero]
    raise ValueError(f"direction must be 'down' or 'up', not {direction!r}")


def recon_banded_plain_(y, u, v, residuals, luma_mode, bpred, chroma_mode, n_band: int) -> None:
    """Torch twin of K16; writes the planes y/u/v in place."""
    B, H, W = y.shape
    mbh, mbw = H // 16, W // 16
    r_loc = mbh // check_bands(n_band, mbh)
    dev = y.device
    args = (residuals.to(torch.int32), luma_mode.long(), bpred.long(), chroma_mode.long())
    sizes = ((y, 16), (u, 8), (v, 8))
    # bands[k][j]: band k of plane j with a halo row above and the 129 column.
    bands = [[_bordered(p[:, k * r_loc * n:(k + 1) * r_loc * n]) for p, n in sizes]
             for k in range(n_band)]
    for t in range(mbw + 2 * (mbh - 1)):
        for j in range(3):
            halos = band_shift([band[j][:, -1] for band in bands], "down")
            for k in range(1, n_band):  # band 0 keeps the frame's 127 row
                bands[k][j][:, 0] = halos[k]
        for k, band in enumerate(bands):
            rows = diagonal(t, range(k * r_loc, (k + 1) * r_loc), mbw)
            if rows is not None:
                R, X = (a.to(dev) for a in rows)
                recon_mbs_(*band, R - k * r_loc, X, R * mbw + X, R > 0, *args)
    for j, (p, n) in enumerate(sizes):
        for k, band in enumerate(bands):
            p[:, k * r_loc * n:(k + 1) * r_loc * n] = band[j][:, 1:, 1:].to(torch.uint8)


def filter_banded_plain_(y, u, v, level, interior, hev, do_sub, simple: bool,
                         n_band: int) -> None:
    """Torch twin of K17; filters y/u/v in place."""
    B, H, W = y.shape
    mbh, mbw = H // 16, W // 16
    r_loc = mbh // check_bands(n_band, mbh)
    dev = y.device
    sizes = ((y, 16),) if simple else ((y, 16), (u, 8), (v, 8))
    params = filter_params(level, interior, hev, do_sub)
    # bands[k][j]: band k of plane j with 4 halo rows above and 4 columns left.
    bands = [[(F.pad(p[:, k * r_loc * n:(k + 1) * r_loc * n].to(torch.int32), (4, 0, 4, 0)), n)
              for p, n in sizes] for k in range(n_band)]
    for t in range(mbw + 2 * (mbh - 1)):
        for j in range(len(sizes)):
            halos = band_shift([band[j][0][:, -4:] for band in bands], "down")
            for k, band in enumerate(bands):
                band[j][0][:, :4] = halos[k]
        for k, band in enumerate(bands):
            rows = diagonal(t, range(k * r_loc, (k + 1) * r_loc), mbw)
            if rows is not None:
                R, X = (a.to(dev) for a in rows)
                M = R * mbw + X
                filter_mbs_(band, R - k * r_loc, X, R > 0, [p[:, M] for p in params], simple)
        # The 3 rows each band's first MB row wrote above itself go back to
        # the band above, at the columns of the MB it filtered.
        for j, (_, n) in enumerate(sizes):
            back = band_shift([band[j][0][:, 1:4] for band in bands], "up")
            for k in range(n_band - 1):
                x = t - 2 * (k + 1) * r_loc
                if 0 <= x < mbw:
                    cols = slice(4 + x * n, 4 + (x + 1) * n)
                    bands[k][j][0][:, -3:, cols] = back[k][:, :, cols]
    for j, (p, n) in enumerate(sizes):
        for k, band in enumerate(bands):
            p[:, k * r_loc * n:(k + 1) * r_loc * n] = band[j][0][:, 4:, 4:].to(torch.uint8)


def band_schedule(mbh: int, mbw: int, n_band: int, pipes: int, seed: int, wait: int = WAIT):
    """The banded kernels' schedule: yields (r, i), MB row r's iteration i
    (MB i), one at a time.  Band k holds rows [k r_loc, (k + 1) r_loc) and
    min(pipes, r_loc) pipelines; pipeline g takes the band's rows g, g +
    pipes, ... in order, each through its mbw iterations.  At each step a
    pipeline is drawn (numpy RandomState(seed)) among those whose next
    iteration i may start: row r - 1 (in the band, or the band above's last
    row) has finished min(i + wait, mbw).  Raises RuntimeError if no
    pipeline may go on before all rows are done (a deadlock)."""
    r_loc = mbh // check_bands(n_band, mbh)
    rng = np.random.RandomState(seed)
    queues = [list(range(k * r_loc + g, (k + 1) * r_loc, pipes))
              for k in range(n_band) for g in range(min(pipes, r_loc))]
    done = [0] * mbh
    while any(queues):
        ready = [q for q in queues if q and (
            q[0] == 0 or done[q[0] - 1] >= min(done[q[0]] + wait, mbw))]
        if not ready:
            raise RuntimeError(f"no pipeline may go on: rows done {done}")
        q = ready[rng.randint(len(ready))]
        r = q[0]
        yield r, done[r]
        done[r] += 1
        if done[r] == mbw:
            q.pop(0)


def recon_banded_rows_plain_(y, u, v, residuals, luma_mode, bpred, chroma_mode, n_band: int,
                             pipes: int, seed: int, wait: int = WAIT) -> None:
    """K16's schedule on the host (`band_schedule`, `pipes` pipelines a
    band), each iteration one MB's recon from the saved unfiltered edges
    (`recon_filter.RowSteps`); writes y/u/v.  Equals `recon_banded_plain_`
    for every seed at wait 2.  Tests only."""
    mbh, mbw = y.shape[1] // 16, y.shape[2] // 16
    steps = RowSteps(y, u, v, False, recon_args=(residuals, luma_mode, bpred, chroma_mode))
    for r, i in band_schedule(mbh, mbw, n_band, pipes, seed, wait):
        steps.recon(r, i)
    steps.finish(y, u, v)


def filter_banded_rows_plain_(y, u, v, level, interior, hev, do_sub, simple: bool, n_band: int,
                              pipes: int, seed: int, wait: int = WAIT) -> None:
    """K17's schedule on the host (`band_schedule`), each iteration one MB's
    filter in the planes; filters y/u/v in place.  Equals
    `filter_banded_plain_` for every seed at wait 2.  Tests only."""
    mbh, mbw = y.shape[1] // 16, y.shape[2] // 16
    steps = RowSteps(y, u, v, simple, filter_args=(level, interior, hev, do_sub))
    for r, i in band_schedule(mbh, mbw, n_band, pipes, seed, wait):
        steps.filter(r, i)
    steps.finish(y, u, v)


def recon_banded_(y, u, v, residuals, luma_mode, bpred, chroma_mode, n_band: int) -> None:
    """K2's reconstruction (`wavefront.recon_`, the same arguments) with the
    MB rows in `n_band` bands: K16 for CUDA tensors, its twin for CPU ones."""
    dev = _build.same_device(y, u, v, residuals, luma_mode, bpred, chroma_mode)
    B, H, W = y.shape
    mbh, mbw = H // 16, W // 16
    check_bands(n_band, mbh)
    if dev.type == "cpu":
        return recon_banded_plain_(y, u, v, residuals, luma_mode, bpred, chroma_mode, n_band)
    nmb = mbw * mbh
    edge = torch.empty((B, mbh, 32 * mbw), dtype=torch.uint8, device=dev)
    _build.launch(
        "recon_banded", "webp_recon_banded", dev,
        _build.dense(residuals, torch.int32, (B, nmb, 24, 16)),
        *_build.mb_field(luma_mode, B, nmb), *_build.mb_field(bpred, B, nmb, 16),
        *_build.mb_field(chroma_mode, B, nmb),
        mbw, mbh, B, n_band,
        *_build.plane(y, B, mbh * 16, mbw * 16), *_build.plane(u, B, mbh * 8, mbw * 8),
        *_build.plane(v, B, mbh * 8, mbw * 8), edge.data_ptr(),
    )


def filter_banded_(y, u, v, level, interior, hev, do_sub, simple: bool, n_band: int) -> None:
    """K3's loop filter (`loopfilter.loop_filter_`, the same arguments) with
    the MB rows in `n_band` bands: K17 for CUDA tensors, its twin for CPU
    ones."""
    dev = _build.same_device(y, u, v, level, interior, hev, do_sub)
    B, H, W = y.shape
    mbh, mbw = H // 16, W // 16
    check_bands(n_band, mbh)
    if dev.type == "cpu":
        return filter_banded_plain_(y, u, v, level, interior, hev, do_sub, simple, n_band)
    nmb = mbw * mbh
    args = [*_build.plane(y, B, H, W), *_build.plane(u, B, mbh * 8, mbw * 8),
            *_build.plane(v, B, mbh * 8, mbw * 8)]
    for f in (level, interior, hev, do_sub):
        args += _build.mb_field(f, B, nmb)
    _build.launch("filter_banded", "webp_filter_banded", dev, *args, mbw, mbh, B, int(simple),
                  n_band)


class BandShape(NamedTuple):
    pipelines: int        # row pipelines (one warp each) of a band's CTA
    smem_bytes: int       # its dynamic shared memory: the rows' counters, the pipelines' tiles
    recon_clusters: int   # K16 clusters of n_band such CTAs the card holds at once
    filter_clusters: int  # K17's


def max_active_clusters(n_band: int, mbh: int) -> BandShape:
    """The CTA shape of K16 and K17 for bands of mbh / n_band MB rows, and
    how many clusters of `n_band` such CTAs the current card holds at once
    (cudaOccupancyMaxActiveClusters)."""
    check_bands(n_band, mbh)
    out = (ctypes.c_int * 4)()
    rc = _build.load().webp_banded_max_clusters(n_band, mbh, out)
    if rc != 0:
        raise RuntimeError(f"webp_banded_max_clusters failed: CUDA error {rc}")
    return BandShape(*out)

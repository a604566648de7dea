"""Sharded batch codec pipelines over a `parallel.mesh.Mesh`.

The counterparts of `webp_tpu/parallel/pipeline.py`:

- `decode_wavefront_banded` (:60, with the halo shifts of :37): K2's
  reconstruction and K3's loop filter with each image's MB rows split into
  `mesh.n_band` bands, run as kernels K16 and K17 on the CTAs of a
  thread-block cluster (`ops/banded.py`).
- The data-parallel factories (:142, :174, :198, :239): each rank runs the
  single-card pipeline on its own shard of the batch and gets its own
  outputs back, with no collective, except the token factory, which
  `all_gather`s every image's lanes to every rank as :272 does.  The
  per-image inputs are the rank's shard; the encoder's parameters and
  tables may also be one set shared by all images, or the whole batch's,
  of which each rank takes its rows (`EncParams.rows`, `EncTables.rows`).

Each step takes the port's own input forms (the decode the upload of
`decode.device.to_device_batch`) and returns what the JAX package's step
returns: the two-pass factory's second step runs K5 then K18 and returns
the rank's int8 prepack 5-tuple, as `_prepack_batch_pertbl` does
(`ops/wire.py`); `ops.wire.unpack_analysis` turns its rows into the arrays
that finish into the unsharded flow's payloads.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..decode.device import decode_core, geometry, split_planes
from ..encode.device import encode_analysis_stats_batch
from ..encode.vp8 import check_partitions
from ..ops import token_ops
from ..ops.banded import check_bands, filter_banded_, recon_banded_
from ..ops.boolenc2 import Lanes
from ..ops.encode_wavefront import encode_analysis_batch
from ..ops.wire import prepack


def decode_wavefront_banded(residuals, luma_mode, bpred, chroma_mode, level, interior, hev,
                            do_sub, mesh, mbw: int, mbh: int, simple: bool):
    """Reconstruction + loop filter with the MB rows in `mesh.n_band` bands
    per image: residuals int32 [B, nmb, 24, 16], the per-MB uint8 fields
    luma_mode, chroma_mode, level, interior, hev [B, nmb] and bpred [B, nmb,
    16], do_sub bool [B, nmb] (as `decode_core` builds them) -> (y [B,
    mbh*16, mbw*16], u, v [B, mbh*8, mbw*8]) uint8 on their device.
    `mesh.n_band` must divide mbh (ValueError)."""
    n_band = check_bands(mesh.n_band, mbh)
    B = residuals.shape[0]
    packed = torch.empty((B, mbw * mbh * 384), dtype=torch.uint8, device=residuals.device)
    y, u, v = split_planes(packed, mbw, mbh)
    recon_banded_(y, u, v, residuals, luma_mode, bpred, chroma_mode, n_band)
    filter_banded_(y, u, v, level, interior, hev, do_sub, simple, n_band)
    return y, u, v


def _on_mesh(mesh, *tensors) -> None:
    for t in tensors:
        if t.device.type != mesh.device.type:
            raise ValueError(f"a tensor on {t.device} for a mesh on {mesh.device}")


def _planes_fit(y, mbw: int, mbh: int) -> int:
    """The batch of planes y [B, mbh*16, mbw*16] (ValueError otherwise)."""
    if tuple(y.shape[1:]) != (mbh * 16, mbw * 16):
        raise ValueError(f"planes {tuple(y.shape)} for a {mbw}x{mbh} MB grid")
    return y.shape[0]


def local_rows(x, mesh, batch: int):
    """`x` (EncParams or EncTables) for this rank's `batch` images: itself
    when it holds one set or `batch` sets, else this rank's rows of the
    n_data * batch sets of the whole batch."""
    if x.batch in (1, batch):
        return x
    if x.batch == batch * mesh.n_data:
        return x.rows(mesh.rank * batch, (mesh.rank + 1) * batch)
    raise ValueError(f"{x.batch} parameter sets for {batch} images on each of {mesh.n_data} ranks")


def max_over_ranks(mesh, values):
    """Each of the ints `values`, the largest over the mesh's ranks."""
    if mesh.group is None:
        return list(values)
    t = torch.tensor(values, dtype=torch.int64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return t.tolist()


def all_gather(mesh, t: torch.Tensor) -> torch.Tensor:
    """[n_data * B, ...]: every rank's `t` [B, ...] in rank order (each rank
    must give the same shape)."""
    if mesh.group is None:
        return t
    out = torch.empty((mesh.n_data * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=mesh.group)
    return out


def make_decode_batch_sharded(mesh, mbw: int, mbh: int, simple: bool, width: int, height: int):
    """Data-parallel batched decode: step(dev_batch, out="rgb") runs K1-K4
    (`decode_core`) on this rank's upload (`to_device_batch`) of its own
    payloads and returns its images (RGB [B, height, width, 3], or packed
    planes with out="yuv").  It refuses (ValueError, `geometry`) a batch
    whose images differ in frame, or whose frame is not the step's."""
    want = (mbw, mbh, bool(simple), width, height)

    def step(dev_batch, out: str = "rgb"):
        got = geometry(dev_batch["headers"])
        if got != want:
            raise ValueError(f"batch of geometry {got}, the step's is {want}")
        _on_mesh(mesh, dev_batch["u8buf"])
        return decode_core(dev_batch, out)

    return step


def make_encode_analysis_sharded(mesh, mbw: int, mbh: int, n_try: int, do_trellis: bool = False):
    """Data-parallel one-pass RD analysis: step(y, u, v, P, tbl) runs K5 on
    this rank's planes and returns its per-MB arrays (`encode_analysis_batch`)."""

    def step(y, u, v, P, tbl):
        B = _planes_fit(y, mbw, mbh)
        _on_mesh(mesh, y, u, v)
        return encode_analysis_batch(y, u, v, local_rows(P, mesh, B), local_rows(tbl, mesh, B),
                                     n_try, do_trellis)

    return step


def make_encode_twopass_sharded(mesh, mbw: int, mbh: int, n_try1: int, n_try: int,
                                do_trellis: bool):
    """Data-parallel two-pass encode kernels, with per-image segment
    parameters, segment ids and tables: (stats_step, prepack_step).

    stats_step(y, u, v, P, tables, sid=None): pass 1, K5 at `n_try1` with no
    trellis, then K6 -> this rank's (totals, ones) [B, 4, 8, 3, 11] int32.
    prepack_step(y, u, v, P, tables, sid=None): pass 2, K5 at `n_try` with
    the trellis if `do_trellis`, then K18 -> this rank's (lv8, meta8,
    esc_pos, esc_val, overflow) (`ops.wire.prepack`).  The host half
    (probability adaptation, K7's tables, `ops.wire.unpack_analysis`, the
    finisher) is the unsharded flow's (`encode/device.py`)."""

    def stats_step(y, u, v, P, tables, sid=None):
        B = _planes_fit(y, mbw, mbh)
        _on_mesh(mesh, y, u, v)
        return encode_analysis_stats_batch(y, u, v, local_rows(P, mesh, B),
                                           local_rows(tables, mesh, B), n_try1, sid)

    def prepack_step(y, u, v, P, tables, sid=None):
        B = _planes_fit(y, mbw, mbh)
        _on_mesh(mesh, y, u, v)
        return prepack(encode_analysis_batch(y, u, v, local_rows(P, mesh, B),
                                             local_rows(tables, mesh, B), n_try, do_trellis, sid))

    return stats_step, prepack_step


def make_encode_tokens_sharded(mesh, mbw: int, mbh: int, nparts: int):
    """Data-parallel device token coding: step(luma_mode, y2_levels,
    y_levels, uv_levels, probs) runs K13 on this rank's images (pass 2's
    arrays and their probabilities [B, 1056] or [B, 4, 8, 3, 11] uint8) and
    returns every rank's coefficient partitions, gathered over `data` in
    rank order: `Lanes` [n_data * B, nparts] on every rank.  Every rank must
    hold the same number of images.

    A rank's lanes come back cut to its largest byte count, which differs
    between ranks; each pads its bytes with zeros to the largest over all
    ranks before the gather, which is what K13 leaves past a lane's
    `n_bytes` at any capacity."""
    check_partitions(nparts)

    def step(luma_mode, y2_levels, y_levels, uv_levels, probs) -> Lanes:
        B = luma_mode.shape[0]
        _on_mesh(mesh, luma_mode, y2_levels, y_levels, uv_levels, probs)
        most, fewest = max_over_ranks(mesh, [B, -B])
        if most != -fewest:  # every rank sees the same counts and raises
            raise ValueError(f"the global batch does not split evenly over {mesh.n_data} ranks: "
                             f"{-fewest} to {most} images a rank")
        lanes = token_ops.encode_coeff_partitions(luma_mode, y2_levels, y_levels, uv_levels,
                                                  probs.reshape(B, -1), mbw, mbh, nparts)
        width, = max_over_ranks(mesh, [lanes.data.shape[-1]])
        data = F.pad(lanes.data, (0, width - lanes.data.shape[-1]))
        return Lanes.from_fields(all_gather(mesh, lanes.fields()), all_gather(mesh, data))

    return step

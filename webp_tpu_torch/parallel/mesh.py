"""The port's mesh: how the codec's two parallel axes map onto GPUs.

The counterpart of `webp_tpu/parallel/mesh.py:19` `make_mesh`, whose JAX
mesh has two axes over devices:

- `data` (independent images) maps onto the ranks of a `torch.distributed`
  process group, one card per rank: each rank passes its shard of a batch
  and gets its own outputs back, as a JAX global array's addressable
  shards.  The group's backend is NCCL for a `cuda` mesh and gloo for a
  `cpu` one; with no process group initialised the mesh is the
  one-process mesh.
- `band` (stripes of MB rows inside one image) maps onto the CTAs of one
  thread-block cluster on one card (`ops/banded.py`), not onto ranks: the
  halo exchange happens at every wavefront step, which a cluster barrier
  does in a fraction of a microsecond and a collective between cards does
  not.  `n_band` counts CTAs per image, at most 8, the portable cluster
  size.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..ops.banded import check_bands

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


class Mesh(NamedTuple):
    """group: the process group over `data` (None: one process, no
    collectives); n_data its ranks; n_band CTAs per image; rank this
    process's rank in the group; device the card (or the CPU) this rank
    works on."""

    group: object
    n_data: int
    n_band: int
    rank: int
    device: torch.device


def make_mesh(n_data: int = None, n_band: int = 1, group=None, device="cuda") -> Mesh:
    """The mesh of `group` (None: the default group when one is initialised,
    else one process) with `n_band` CTAs per image.  `n_data`, when given,
    must equal the group's size.  Raises ValueError for a device type
    without a backend, a group whose backend does not serve the device (a
    `cuda` mesh needs NCCL, a `cpu` one gloo), or `n_band` outside 1..8."""
    dev = torch.device(device)
    if dev.type not in BACKENDS:
        raise ValueError(f"a mesh runs on cuda or cpu, not {dev.type}")
    check_bands(n_band)
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD if group is None else group
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        backend = str(dist.get_backend(group))
        if BACKENDS[dev.type] not in backend:
            raise ValueError(f"a {dev.type} mesh needs a {BACKENDS[dev.type]} process group, "
                             f"not {backend}")
    elif group is not None:
        raise ValueError("a group was given but no process group is initialised")
    else:
        world, rank = 1, 0
    if n_data is None:
        n_data = world
    if n_data != world:
        raise ValueError(f"n_data {n_data} != the group's {world} ranks (one card per rank)")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group, n_data, n_band, rank, dev)

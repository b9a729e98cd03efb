"""A logical device mesh over the ranks of the process group (counterpart of
`manigaussian_tpu/parallel/mesh.py`).

JAX builds a `jax.sharding.Mesh` over its devices and lets XLA place the
collectives. Here each rank is one process holding one device, and a `Mesh`
gives the rank its coordinates on named axes ("data" for the batch, "tile"
for the renderer's image tiles) and, for each axis, the process group of the
ranks that differ from it only along that axis. Ranks fill the mesh in
row-major order: on a ("data", "tile") mesh of (D, T), rank d·T + t holds
data row block d and tile window t.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from manigaussian_tpu_torch.parallel.distributed import (Rows, all_reduce,
                                                         global_batch)


class Mesh:
    """This rank's place on the mesh: `shape` and `coords` by axis name,
    and a process group per axis. An axis the mesh lacks has size 1, index
    0 and no group."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], rank: int,
                 groups: Dict[str, object]):
        self.axes = tuple(axes)
        self.shape = dict(zip(self.axes, (int(s) for s in shape)))
        self.rank = rank
        self.coords = dict(zip(self.axes, (int(c) for c in np.unravel_index(
            rank, tuple(self.shape.values())))))
        self.groups = groups

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)

    def __contains__(self, axis: str) -> bool:
        return axis in self.shape

    def rows(self, local_b: int, axis: str = "data") -> Rows:
        """Where this rank's `local_b` rows sit in the global batch."""
        return Rows(self.index(axis) * local_b, self.size(axis) * local_b)

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum"
                   ) -> torch.Tensor:
        """`t` reduced over `axis` (as it is when the mesh lacks the axis)."""
        if axis not in self:
            return t
        return all_reduce(t, op, self.group(axis))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def make_mesh(shape: Sequence[int] = (-1,),
              axes: Sequence[str] = ("data",)) -> Mesh:
    """A mesh over all ranks of the initialized process group; one -1 entry
    of `shape` takes what the others leave (JAX `make_mesh`). The mesh must
    hold every rank. Every rank creates every axis group in the same
    (row-major) order, as `dist.new_group` requires."""
    world = dist.get_world_size()
    shape = list(shape)
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        shape[shape.index(-1)] = world // known
    if math.prod(shape) != world:
        raise ValueError(f"mesh {tuple(shape)} over {axes} does not hold the "
                         f"{world} ranks")
    ids = np.arange(world).reshape(shape)
    me = dist.get_rank()
    groups = {}
    for i, axis in enumerate(axes):
        lines = np.moveaxis(ids, i, -1).reshape(-1, shape[i])
        for line in lines:
            ranks = [int(r) for r in line]
            g = dist.new_group(ranks)
            if me in ranks:
                groups[axis] = g
    return Mesh(shape, axes, me, groups)


def shard_batch(batch: Dict, mesh: Optional[Mesh], axis: str = "data"
                ) -> Dict:
    """This rank's rows of the global batch (the batch as it is without a
    mesh or a data axis)."""
    if mesh is None or axis not in mesh:
        return batch
    return global_batch(batch, mesh, axis)


@torch.no_grad()
def replicate_state(module: torch.nn.Module, optimizer=None) -> None:
    """Broadcast the parameters and buffers of `module`, and the moments and
    update count of `optimizer` (`Lamb` or `AdamW`) when given, from rank 0
    to every rank, in place."""
    tensors = list(itertools.chain(module.parameters(), module.buffers()))
    if optimizer is not None:
        tensors += optimizer.mu + optimizer.nu
    for t in tensors:
        dist.broadcast(t.data, src=0)
    if optimizer is not None:
        count = torch.tensor([optimizer.count], dtype=torch.float64,
                             device=tensors[0].device)
        dist.broadcast(count, src=0)
        optimizer.count = int(count.item())

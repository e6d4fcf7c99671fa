"""The data axis of a device mesh, one process per device.

The port's counterpart of ``seld_tpu/parallel/mesh.py`` for its data axis:
the JAX package builds a ``('data', 'model')`` mesh and GSPMD inserts the
collectives from the batch's sharding; here :class:`DataMesh` holds the
process group and the data-axis size, each rank holds its rows of a global
batch (:func:`shard_batch`), and the step sums its batch statistics and
averages its gradients over the group (``parallel/cross_rank.py``,
``training/steps.py``). Tensor parallelism (``mesh_model > 1``,
``seld_tpu/parallel/mesh.py:45-67``: output features sharded over a 'model'
axis) is not ported: the ctypes-launched kernels would need to take sharded
weights (ROADMAP, modules item 3), and ``make_mesh`` raises for it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from seld_tpu_torch.parallel.cross_rank import CrossRank


class DataMesh:
    """The data axis: ``n_data`` ranks of ``group``, one device each."""

    def __init__(self, n_data: int, group=None):
        self.group = group
        self.n_data = int(n_data)
        self.rank = dist.get_rank(group) if dist.is_initialized() else 0
        self.cross_rank = CrossRank(group) if self.n_data > 1 else None

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": 1}


def make_mesh(n_data: int = -1, n_model: int = 1, group=None) -> DataMesh:
    """The data mesh of the process group: ``n_data = -1`` takes every rank;
    any other value must equal the group's size (one process per device).
    ``n_model > 1`` raises."""
    if n_model > 1:
        raise NotImplementedError(
            f"mesh_model={n_model}: tensor-parallel output-feature sharding is not ported "
            "(ROADMAP, modules still to port, item 3: the kernels would take sharded weights)")
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    if n_data == -1:
        n_data = world
    if n_data != world:
        raise ValueError(f"mesh_data={n_data}: the data axis is one rank a device, so it "
                         f"must be -1 or the world size {world}")
    return DataMesh(n_data, group)


class BatchSharding(NamedTuple):
    """This rank's block of a global batch: ``n_shards`` equal contiguous
    blocks in rank order."""
    shard_id: int
    n_shards: int

    def rows(self, n_global: int) -> slice:
        if n_global % self.n_shards:
            raise ValueError(f"a global batch of {n_global} rows does not split over "
                             f"{self.n_shards} ranks")
        local = n_global // self.n_shards
        return slice(self.shard_id * local, (self.shard_id + 1) * local)


def batch_sharding(mesh: DataMesh) -> BatchSharding:
    """Shard the leading (batch) axis over the data axis."""
    return BatchSharding(mesh.rank, mesh.n_data)


def shard_batch(mesh: DataMesh, *arrays, device=None):
    """This rank's rows of each global batch (numpy or tensors), as tensors
    on ``device`` (their own device if None)."""
    block = batch_sharding(mesh)
    out = []
    for a in arrays:
        t = torch.from_numpy(np.asarray(a)) if not isinstance(a, torch.Tensor) else a
        t = t[block.rows(t.shape[0])]
        out.append(t.to(device) if device is not None else t)
    return tuple(out) if len(out) > 1 else out[0]

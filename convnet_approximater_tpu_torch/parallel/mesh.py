"""The ``(data, model)`` mesh over the ranks (port of the data-axis half of
``convnet_approximater_tpu/parallel/mesh.py``).

The JAX package lays arrays out over a ``jax.sharding.Mesh`` in one process
and lets XLA insert the collectives.  Here each rank is one process on one
device: the mesh is a ``torch.distributed`` ``DeviceMesh`` with the same axis
names, a "sharded" batch is the rank's own rows of it, and "replicated"
weights are every rank's copy, broadcast from the data group's first rank.
``param_shardings`` (tensor-parallel layouts) and ``spatial_sharding`` are
still to be ported (ROADMAP.md queue 1, item 12b).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .distributed import process_count

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(data: Optional[int] = None, model: int = 1, device_type: Optional[str] = None):
    """A ``(data, model)`` ``DeviceMesh`` over the process group's ranks:
    rank ``d * model + m`` sits at ``(d, m)``.  ``device_type`` defaults to
    ``cuda`` on an NCCL group and ``cpu`` on gloo."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.initialize_distributed first")
    n = process_count()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"{data}x{model} mesh != {n} devices")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_ranks(mesh, axis: str):
    """``(index of this rank along axis, the axis's size, the axis's group,
    the global rank of each index)``."""
    group = mesh.get_group(axis)
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    return (mesh.get_local_rank(axis), size, group,
            [dist.get_global_rank(group, i) for i in range(size)])


def batch_sharding(mesh) -> Tuple[int, int]:
    """``(index, count)``: this rank's place on the data axis, the part of
    every global batch it holds (the ``Loader``'s ``sharding=``)."""
    index, count, _, _ = axis_ranks(mesh, DATA_AXIS)
    return index, count


def shard_rows(n: int, sharding: Tuple[int, int]) -> slice:
    """The contiguous rows of ``n`` that ``sharding`` holds; ``n`` must split evenly."""
    index, count = sharding
    if n % count:
        raise ValueError(f"a batch of {n} rows does not split over {count} data ranks")
    per = n // count
    return slice(index * per, (index + 1) * per)


def pad_indices(idx: np.ndarray, count: int) -> np.ndarray:
    """The batch ``idx`` tiled up to the next multiple of ``count`` rows, its
    rows repeated from the start, as ``deploy.pad_batch_to_multiple`` tiles a batch."""
    return idx[np.arange(-(-len(idx) // count) * count) % len(idx)]


def shard_indices(idx: np.ndarray, sharding: Tuple[int, int], pad: bool = False) -> np.ndarray:
    """The rows of the global batch ``idx`` that ``sharding`` holds.  With
    ``pad``, a batch that does not split evenly is first tiled up to the next
    multiple of the ranks (:func:`pad_indices`); without, it must split evenly."""
    if pad:
        idx = pad_indices(idx, sharding[1])
    return idx[shard_rows(len(idx), sharding)]


def shard_batch(batch, mesh):
    """This rank's contiguous slice of the leading axis of ``batch`` (a tensor,
    or a tuple or list of them) over the data axis."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, mesh) for b in batch)
    return batch[shard_rows(batch.shape[0], batch_sharding(mesh))]


def replicate(module: nn.Module, mesh) -> nn.Module:
    """Every rank of a data group takes the parameters and buffers of the
    group's first rank."""
    _, count, group, ranks = axis_ranks(mesh, DATA_AXIS)
    if count > 1:
        broadcast_module(module, group, ranks[0])
    return module


@torch.no_grad()
def broadcast_module(module: nn.Module, group, src: int) -> None:
    """Copy global rank ``src``'s parameters and buffers into every rank of
    ``group`` (a copy into each tensor, so the kernel layers' caches, keyed on
    weight versions, see the change)."""
    for t in list(module.parameters()) + list(module.buffers()):
        incoming = t.detach().contiguous().clone()  # collectives take dense tensors
        dist.broadcast(incoming, src=src, group=group)
        t.copy_(incoming)


def pad_to_multiple(batch, multiple: int):
    """Pad the leading axis with zeros up to a multiple of ``multiple`` (to
    split evenly); returns ``(padded, valid_count)``."""
    n = batch.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return batch, n
    if isinstance(batch, torch.Tensor):
        pad = torch.zeros((rem,) + tuple(batch.shape[1:]), dtype=batch.dtype, device=batch.device)
        return torch.cat([batch, pad]), n
    pad = [(0, rem)] + [(0, 0)] * (batch.ndim - 1)
    return np.pad(np.asarray(batch), pad), n

"""Training across processes on the data axis (port of the training half of
``convnet_approximater_tpu/parallel/``).

The JAX trainers jit one SPMD step over a global batch sharded on the mesh's
data axis, so XLA makes the gradient sums, the metric means and BatchNorm's
batch statistics global reductions.  Here each rank is one process on one
device that loads and steps on its own rows of every global batch
(``Loader(sharding=parallel.batch_sharding(mesh))``), and the reductions are
explicit:

* BatchNorm's statistics and the drop masks: ``nn.sharded_batch`` around the
  training forward and its backward (``nn/layers.py``);
* the gradients: :func:`average_gradients`, called by the optimizer once per
  update (after ``grad_accum``'s micro-steps, before clipping) over the
  parameters the update trains: the trainable set changes from epoch to
  epoch, which a reducer fixed at construction (``DistributedDataParallel``)
  cannot follow;
* Mixup/CutMix partners on other ranks: :func:`all_gather_rows`;
* metric sums, the preemption stop: :func:`sum_over`, :func:`any_rank`.

Every rank starts from the data axis's first rank's weights
(:func:`replicate_from_root`) and takes the same updates, so the weights, the
optimizer state and the EMA stay equal on every rank.

Pipelined training (``TrainHelper(pipeline_parallel=pp)``) runs on a
``(world / pp, pp)`` mesh (:func:`training_mesh`): the data axis is the
ranks that share a pipe index, the pipe ranks of a data group load the same
rows, and every rank starts from the first rank's weights before any block
is released.  The parameters outside the pipelined blocks are replicated
over the pipe group: their gradients are broadcast from pipe rank 0 after
the data axis's mean (:class:`PipeAxis`, :func:`broadcast_gradients`), so
they stay bit-equal whatever order cuDNN sums in.

Tensor-parallel training (``model_parallel=mp`` in both trainers) runs on a
``(world / mp, mp)`` mesh the same way: the model ranks of a data group load
the same rows, every rank starts from the first rank's whole weights before
it keeps its shards (``parallel/tp.py::shard_module``), the sharded
parameters' gradients are averaged over the data axis alone, and the
replicated ones are broadcast from model rank 0 after that mean (the model
axis is a :class:`PipeAxis` whose ``owned`` parameters are the shards).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from convnet_approximater_tpu_torch.nn import DataShard

from .distributed import process_count
from .mesh import DATA_AXIS, MODEL_AXIS, axis_ranks, batch_sharding, broadcast_module, make_mesh

BUCKET_BYTES = 32 << 20  # the gradients are averaged in flat buckets of at most this size


class PipeAxis(NamedTuple):
    """A rank's place on the model axis of pipelined or tensor-parallel
    training."""

    group: object  # the model group (this rank's data index, every model index)
    root: int  # the global rank of model index 0: the replicated gradients' source
    owned: FrozenSet[str]  # the parameters this rank holds alone: its blocks, or its shards
    dims: Optional[Dict[str, int]] = None  # tensor parallelism: each shard's sharded dim


def training_mesh(use_mesh: bool, model: int = 1, option: str = "pipeline_parallel"):
    """The ``(world / model, model)`` mesh of training across processes, or
    None when ``use_mesh`` is off or the process is alone.  Collective."""
    if not use_mesh or process_count() == 1:
        return None
    if process_count() % model:
        raise ValueError(f"{option}={model} does not divide the {process_count()} processes")
    return make_mesh(model=model)


def training_axis(use_mesh: bool, mesh=None) -> Optional[DataShard]:
    """This rank's place on the data axis of ``mesh`` (default a ``(world,
    1)`` mesh, :func:`~.mesh.make_mesh`, :func:`~.mesh.batch_sharding`), or
    None when ``use_mesh`` is off, the process is alone or the axis has one
    rank.  Collective: every rank calls it together (it makes the mesh's
    groups and a gloo group for host-side values)."""
    if not use_mesh or process_count() == 1:
        return None
    mesh = mesh if mesh is not None else make_mesh()
    index, count = batch_sharding(mesh)
    _, _, group, ranks = axis_ranks(mesh, DATA_AXIS)
    host = group if dist.get_backend(group) == "gloo" else dist.new_group(ranks, backend="gloo")
    return DataShard(index, count, group, host, ranks[0]) if count > 1 else None


def world_axis() -> DataShard:
    """Every rank of the process group as one axis (a pipelined run's ranks
    decide a stop together)."""
    world = dist.group.WORLD
    host = world if dist.get_backend() == "gloo" else dist.new_group(backend="gloo")
    return DataShard(dist.get_rank(), dist.get_world_size(), world, host, 0)


def pipe_axis(mesh, owned: FrozenSet[str], dims: Optional[Dict[str, int]] = None) -> PipeAxis:
    """This rank's :class:`PipeAxis` on ``mesh``'s model axis."""
    _, _, group, ranks = axis_ranks(mesh, MODEL_AXIS)
    return PipeAxis(group, ranks[0], frozenset(owned), dims)


def replicate_from_root(module: nn.Module, shard: Optional[DataShard], mesh=None) -> nn.Module:
    """Every rank of the data axis takes its first rank's parameters and
    buffers; with a pipelined ``mesh``, every rank of the world takes rank 0's."""
    if mesh is not None:
        broadcast_module(module, dist.group.WORLD, 0)
    elif shard is not None:
        broadcast_module(module, shard.group, shard.root)
    return module


def _buckets(grads: Sequence[torch.Tensor]):
    """The gradients in flat buckets of one type and device, at most BUCKET_BYTES each."""
    buckets, size = {}, {}
    for g in grads:
        key = (g.dtype, g.device)
        if key not in buckets or size[key] + g.numel() * g.element_size() > BUCKET_BYTES:
            buckets.setdefault(key, []).append([])
            size[key] = 0
        buckets[key][-1].append(g)
        size[key] += g.numel() * g.element_size()
    return [b for per_key in buckets.values() for b in per_key]


def _unflatten(flat: torch.Tensor, bucket) -> None:
    offset = 0
    for g in bucket:
        g.copy_(flat[offset:offset + g.numel()].view(g.shape))
        offset += g.numel()


@torch.no_grad()
def average_gradients(grads: Sequence[torch.Tensor], shard: DataShard) -> None:
    """Replace each gradient, in place, by its mean over the data axis: one
    ``all_reduce`` per bucket of flattened gradients of one type and device."""
    for bucket in _buckets(grads):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=shard.group)
        flat /= shard.count
        _unflatten(flat, bucket)


@torch.no_grad()
def broadcast_gradients(grads: Sequence[torch.Tensor], pipe: PipeAxis) -> None:
    """Replace each gradient, in place, by pipe rank 0's: one ``broadcast`` per bucket."""
    for bucket in _buckets(grads):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.broadcast(flat, src=pipe.root, group=pipe.group)
        _unflatten(flat, bucket)


def all_gather_rows(t: torch.Tensor, shard: DataShard) -> torch.Tensor:
    """The global batch of ``t``: every rank's rows, concatenated in rank order
    (bfloat16 travels as float32, which holds it exactly)."""
    send = (t.float() if t.dtype == torch.bfloat16 else t).contiguous()
    parts = [torch.empty_like(send) for _ in range(shard.count)]
    dist.all_gather(parts, send, group=shard.group)
    return torch.cat(parts).to(t.dtype)


def sum_over(values: List[float], shard: Optional[DataShard], device) -> List[float]:
    """``values`` summed over the data axis (in float64), or as they are alone."""
    if shard is None:
        return list(values)
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t, group=shard.group)
    return t.tolist()


def any_rank(flag: bool, shard: Optional[DataShard]) -> bool:
    """Whether ``flag`` is set on any rank of the data axis (a MAX over the
    host group, so no rank waits alone in a collective after the others
    stopped)."""
    if shard is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=shard.host)
    return bool(t.item())

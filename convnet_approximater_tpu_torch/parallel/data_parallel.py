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
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from convnet_approximater_tpu_torch.nn import DataShard

from .distributed import process_count
from .mesh import DATA_AXIS, axis_ranks, batch_sharding, broadcast_module, make_mesh

BUCKET_BYTES = 32 << 20  # the gradients are averaged in flat buckets of at most this size


def training_axis(use_mesh: bool) -> Optional[DataShard]:
    """This rank's place on the data axis of a ``(world, 1)`` mesh
    (:func:`~.mesh.make_mesh`, :func:`~.mesh.batch_sharding`), or None when
    ``use_mesh`` is off or the process is alone.  Collective: every rank
    calls it together (it makes the mesh's groups and a gloo group for
    host-side values)."""
    if not use_mesh or process_count() == 1:
        return None
    mesh = make_mesh()
    index, count = batch_sharding(mesh)
    _, _, group, ranks = axis_ranks(mesh, DATA_AXIS)
    host = group if dist.get_backend(group) == "gloo" else dist.new_group(ranks, backend="gloo")
    return DataShard(index, count, group, host, ranks[0])


def replicate_from_root(module: nn.Module, shard: Optional[DataShard]) -> nn.Module:
    """Every rank of the data axis takes its first rank's parameters and buffers."""
    if shard is not None:
        broadcast_module(module, shard.group, shard.root)
    return module


@torch.no_grad()
def average_gradients(grads: Sequence[torch.Tensor], shard: DataShard) -> None:
    """Replace each gradient, in place, by its mean over the data axis: one
    ``all_reduce`` per bucket of flattened gradients of one type and device."""
    buckets, size = {}, {}
    for g in grads:
        key = (g.dtype, g.device)
        if key not in buckets or size[key] + g.numel() * g.element_size() > BUCKET_BYTES:
            buckets.setdefault(key, []).append([])
            size[key] = 0
        buckets[key][-1].append(g)
        size[key] += g.numel() * g.element_size()
    for bucket in (b for per_key in buckets.values() for b in per_key):
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=shard.group)
        flat /= shard.count
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view(g.shape))
            offset += g.numel()


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

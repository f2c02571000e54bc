"""Stages of identical blocks run as GPipe pipelines (port of the pipeline
half of ``convnet_approximater_tpu/models/stage_exec.py``; the scan over
blocks is XLA's and the port does not carry it).

A model whose stages are Sequentials of blocks (MSCAN's attention blocks,
ConvNeXt's blocks) mixes in :class:`BlockStageExec` and runs each stage
through :meth:`BlockStageExec._exec_stage`.  After
``enable_pipeline(mesh)``, a stage runs through ``parallel.pipeline_blocks``
over the mesh's ``model`` axis when its blocks form a stack (two or more,
structurally identical, none capturing taps) whose count the axis size
``n`` divides, and as the plain sequence otherwise, as the JAX engine falls
back from such stages.  Each pipe rank keeps only its own blocks' weights.

With autograd off (``torch.no_grad()``, eval mode) a pipelined stage runs
``pipeline_blocks``, which keeps the kernel layers' kernels; with autograd
on, in eval mode too, it runs ``parallel.pipeline_blocks_train``, whose
backward sends the gradients back through the pipe ranks.  In training
mode, as the JAX engine's ``_pipeline_stage``:

* microbatch ``j`` is rows ``[j B/M, (j+1) B/M)`` of the global batch, and
  its BatchNorms normalize by its own statistics: over the rank's rows when
  each data rank holds whole microbatches (``d | M``), over the data ranks
  that share it when one microbatch spans several (``M | d``), through
  ``nn.GlobalBatchNorm`` on a subgroup; any other ``(d, M)`` raises;
* each BatchNorm's running statistics take the mean over the ``M`` global
  microbatches of the update each would make from the step's statistics
  (``nn.MicrobatchStats``, summed over the data axis);
* each (block, microbatch) draws its drop masks from a generator seeded from
  the step's seed, the stage, the block and the global microbatch, at the
  global microbatch's shape, a rank taking its rows (``layers.block_draws``):
  not JAX's ``fold_in`` bits, but the same masks for one process and for any
  split over pipe and data ranks.

One difference from the JAX package: an axis of size 1 pipelines too (the
schedule of ``M`` microbatches on one rank), where the JAX engine runs the
stage unpipelined; ``ClassInference`` and ``TrainHelper`` pipeline only
``pipeline_parallel`` > 1 in both packages.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from convnet_approximater_tpu_torch.layers.drop import block_draws, draws_seed
from convnet_approximater_tpu_torch.nn import (DataShard, MicrobatchStats, current_shard,
                                               microbatch_stats, sharded_batch)
from convnet_approximater_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, axis_ranks,
                                                          broadcast_module)
from convnet_approximater_tpu_torch.parallel.pp import (owned_range, pipeline_blocks,
                                                        pipeline_blocks_train, release, restore,
                                                        structure)
from convnet_approximater_tpu_torch.parallel.spatial import is_spatial, refuse_spatial


def is_stack(stage: nn.Sequential) -> bool:
    """Two or more structurally identical blocks, none capturing taps."""
    blocks = list(stage)
    if len(blocks) < 2 or any(getattr(m, "capture", False) for m in stage.modules()):
        return False
    return all(structure(b) == structure(blocks[0]) for b in blocks[1:])


def microbatch_split(d: int, M: int) -> Tuple[int, int]:
    """``(microbatches per data rank, data ranks per microbatch)`` of ``M``
    global microbatches over ``d`` data ranks; one must divide the other."""
    if M % d == 0:
        return M // d, 1
    if d % M == 0:
        return 1, d // M
    raise ValueError(f"pipelined training: {M} microbatches over {d} data ranks: one must "
                     f"divide the other (each data rank holds whole microbatches, or each "
                     f"microbatch spans whole data ranks)")


class BlockStageExec:
    """Mixin for a model whose :meth:`pipeline_stages` are Sequentials of
    blocks; see the module docstring."""

    _pipeline: Optional[dict] = None

    def pipeline_stages(self) -> List[nn.Sequential]:
        raise NotImplementedError

    def enable_pipeline(self, mesh, axis: str = None, num_microbatches: int = None,
                        stages: Optional[Sequence[int]] = None):
        """Pipeline every stage that can be over ``mesh``'s ``axis`` (default
        ``model``) in ``num_microbatches`` (default the axis size), or only
        those of ``stages`` among them, releasing on this rank the weights of
        the blocks other pipe ranks own.  The stages are read as they stand
        now: enable after any rewrite of them.  ``enable_pipeline(None)`` gives
        every pipe rank each block's weights from its owner (a broadcast over
        the pipe group: collective) and runs every stage plainly again."""
        if self._pipeline is not None:
            self._gather()
            self._pipeline = None
        if mesh is None:
            return
        if is_spatial(self):
            raise refuse_spatial("a pipeline (pipeline_parallel > 1) of a spatially sharded model")
        axis = axis or MODEL_AXIS
        _, n, _, _ = axis_ranks(mesh, axis)
        pipelined, released = [], []
        for s, stage in enumerate(self.pipeline_stages()):
            if is_stack(stage) and len(stage) % n == 0 and (stages is None or s in stages):
                pipelined.append(s)
                own = owned_range(len(stage), mesh, axis)
                released += [(stage[k], release(stage[k])) for k in range(len(stage))
                             if k not in own]
        M = int(num_microbatches or n)
        self._pipeline = dict(mesh=mesh, axis=axis, M=M, stages=pipelined, released=released,
                              subgroups=_microbatch_groups(mesh, axis, M))

    def _gather(self):
        """Every released block gets its owner's weights back (collective)."""
        pipe = self._pipeline
        index, n, group, ranks = axis_ranks(pipe["mesh"], pipe["axis"])
        saved = dict((id(block), s) for block, s in pipe["released"])
        for _, owner, block in self.pipelined_blocks():
            if id(block) in saved:
                restore(block, saved[id(block)])
            if n > 1:
                broadcast_module(block, group, ranks[owner])

    def pipeline_mesh(self):
        """The mesh the stages are pipelined over, or None."""
        return None if self._pipeline is None else self._pipeline["mesh"]

    def pipelined_stages(self) -> List[int]:
        """Indices of the stages that run as pipelines."""
        return [] if self._pipeline is None else list(self._pipeline["stages"])

    def pipelined_blocks(self) -> List[Tuple[int, int, nn.Module]]:
        """``(stage, owner's pipe index, block)`` of every block of a pipelined stage."""
        if self._pipeline is None:
            return []
        _, n, _, _ = axis_ranks(self._pipeline["mesh"], self._pipeline["axis"])
        stages = self.pipeline_stages()
        out = []
        for s in self._pipeline["stages"]:
            per = len(stages[s]) // n
            out += [(s, k // per, block) for k, block in enumerate(stages[s])]
        return out

    def pipe_index(self) -> int:
        """This rank's index on the pipe axis (0 when not pipelined)."""
        pipe = self._pipeline
        return 0 if pipe is None else axis_ranks(pipe["mesh"], pipe["axis"])[0]

    def _exec_stage(self, s: int, stage: nn.Sequential, x):
        pipe = self._pipeline
        if pipe is None or s not in pipe["stages"]:
            return stage(x)
        if stage.training or torch.is_grad_enabled():
            return self._train_stage(s, stage, x)
        return pipeline_blocks(list(stage), x, pipe["mesh"], pipe["axis"], pipe["M"])

    def _train_stage(self, s: int, stage: nn.Sequential, x):
        """The differentiable pipeline of stage ``s``, with training mode's
        microbatch statistics and drop draws (see the module docstring)."""
        pipe = self._pipeline
        M = pipe["M"]
        if not stage.training:
            return pipeline_blocks_train(list(stage), x, pipe["mesh"], pipe["axis"], M)
        shard = current_shard()  # the trainer's data axis, or None
        d, r = (shard.count, shard.index) if shard is not None else (1, 0)
        local, repeats = microbatch_split(d, M)
        micro = None  # the data ranks that share this rank's microbatch
        if repeats > 1:
            groups = pipe["subgroups"].get(repeats)
            if groups is None:
                raise ValueError(f"pipelined training: the pipeline was enabled for {M} "
                                 f"microbatches on another data axis than {d} ranks")
            group, root = groups[r // repeats]
            micro = DataShard(r % repeats, repeats, group, group, root)
        stats = MicrobatchStats(M)
        seed = draws_seed(stage)

        def run_block(k, block, h, j):
            g = r * local + j if repeats == 1 else r // repeats  # the global microbatch
            with sharded_batch(micro), microbatch_stats(stats), \
                    block_draws(block, seed, (s, k, g), h.device):
                return block(h)

        y = pipeline_blocks_train(list(stage), x, pipe["mesh"], pipe["axis"], local, run_block)
        stats.commit(shard.group if shard is not None else None, repeats)
        return y


def _microbatch_groups(mesh, axis: str, M: int) -> Dict[int, list]:
    """Where the mesh's data axis has ``d`` ranks and ``M < d`` divides it: for
    ``d // M`` ranks per microbatch, this rank's pipe index's groups, one per
    microbatch ``(group, its first global rank)``.  Every rank makes every
    group, in one order (collective)."""
    if DATA_AXIS not in (mesh.mesh_dim_names or ()):
        return {}
    _, d, _, _ = axis_ranks(mesh, DATA_AXIS)
    if d <= M or d % M:
        return {}
    repeats = d // M
    grid = mesh.mesh.tolist()  # grid[data index][model index] = global rank
    if mesh.mesh_dim_names.index(axis) == 0:
        grid = [list(col) for col in zip(*grid)]
    mine, _, _, _ = axis_ranks(mesh, axis)
    out = []
    for m in range(len(grid[0])):
        for g in range(M):
            ranks = [grid[i][m] for i in range(g * repeats, (g + 1) * repeats)]
            group = dist.new_group(ranks)
            if m == mine:
                out.append((group, ranks[0]))
    return {repeats: out}


def resolve_pipeline_carrier(model) -> Optional[BlockStageExec]:
    """The module carrying the stage engine: ``model.backbone`` for the MSCAN
    family (SegNeXt too), the model itself for ConvNeXt, else None."""
    backbone = getattr(model, "backbone", None)
    if hasattr(backbone, "enable_pipeline"):
        return backbone
    if hasattr(model, "enable_pipeline"):
        return model
    return None


def block_names(model: nn.Module) -> List[Tuple[str, int]]:
    """``(name in model, owner's pipe index)`` of every block of the model's
    pipelined stages."""
    carrier = resolve_pipeline_carrier(model)
    if carrier is None:
        return []
    names = {id(m): name for name, m in model.named_modules()}
    return [(names[id(block)], owner) for _, owner, block in carrier.pipelined_blocks()]


def owner_of(name: str, blocks: List[Tuple[str, int]]) -> Optional[int]:
    """The owner's pipe index of the block that holds the tensor ``name``, or
    None for a replicated one."""
    for prefix, owner in blocks:
        if name.startswith(prefix + "."):
            return owner
    return None


@torch.no_grad()
def gather_from_owners(model: nn.Module, named: Dict[str, torch.Tensor],
                       device) -> Dict[str, torch.Tensor]:
    """``named`` (tensors keyed by names under ``model``'s pipelined blocks, as
    this rank holds them: its own blocks' real, the others' meta) with every
    block's tensors broadcast from its owner over the pipe group
    (collective: every pipe rank passes the same keys)."""
    carrier = resolve_pipeline_carrier(model)
    pipe = carrier._pipeline if carrier is not None else None
    if pipe is None:
        return dict(named)
    index, n, group, ranks = axis_ranks(pipe["mesh"], pipe["axis"])
    blocks = block_names(model)
    out = {}
    for key, t in named.items():
        owner = owner_of(key, blocks)
        if owner is None or n == 1:
            out[key] = t
            continue
        buf = (t.detach().contiguous().clone() if owner == index
               else torch.empty(t.shape, dtype=t.dtype, device=device))
        dist.broadcast(buf, src=ranks[owner], group=group)
        out[key] = buf
    return out

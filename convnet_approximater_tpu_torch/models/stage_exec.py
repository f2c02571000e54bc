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
A pipelined stage runs in eval mode with autograd off: the training form is
ROADMAP.md queue 1, item 12b.
One difference from the JAX package: an axis of size 1 pipelines too (the
schedule of ``M`` microbatches on one rank), where the JAX engine runs the
stage unpipelined; ``ClassInference`` pipelines only ``pipeline_parallel`` > 1
in both packages.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from convnet_approximater_tpu_torch.parallel.distributed import MESH_TODO
from convnet_approximater_tpu_torch.parallel.mesh import MODEL_AXIS, axis_ranks
from convnet_approximater_tpu_torch.parallel.pp import (owned_range, pipeline_blocks, release,
                                                        restore, structure)


def is_stack(stage: nn.Sequential) -> bool:
    """Two or more structurally identical blocks, none capturing taps."""
    blocks = list(stage)
    if len(blocks) < 2 or any(getattr(m, "capture", False) for m in stage.modules()):
        return False
    return all(structure(b) == structure(blocks[0]) for b in blocks[1:])


class BlockStageExec:
    """Mixin for a model whose :meth:`pipeline_stages` are Sequentials of
    blocks; see the module docstring."""

    _pipeline: Optional[dict] = None

    def pipeline_stages(self) -> List[nn.Sequential]:
        raise NotImplementedError

    def enable_pipeline(self, mesh, axis: str = None, num_microbatches: int = None):
        """Pipeline every stage that can be over ``mesh``'s ``axis`` (default
        ``model``) in ``num_microbatches`` (default the axis size), releasing on
        this rank the weights of the blocks other pipe ranks own.  The stages
        are read as they stand now: enable after any rewrite of them.
        ``enable_pipeline(None)`` gives the released weights back and runs every
        stage plainly again."""
        if self._pipeline is not None:
            for block, saved in self._pipeline["released"]:
                restore(block, saved)
            self._pipeline = None
        if mesh is None:
            return
        axis = axis or MODEL_AXIS
        _, n, _, _ = axis_ranks(mesh, axis)
        stages, released = [], []
        for s, stage in enumerate(self.pipeline_stages()):
            if is_stack(stage) and len(stage) % n == 0:
                stages.append(s)
                own = owned_range(len(stage), mesh, axis)
                released += [(stage[k], release(stage[k])) for k in range(len(stage))
                             if k not in own]
        self._pipeline = dict(mesh=mesh, axis=axis, M=num_microbatches, stages=stages,
                              released=released)

    def pipeline_mesh(self):
        """The mesh the stages are pipelined over, or None."""
        return None if self._pipeline is None else self._pipeline["mesh"]

    def pipelined_stages(self) -> List[int]:
        """Indices of the stages that run as pipelines."""
        return [] if self._pipeline is None else list(self._pipeline["stages"])

    def _exec_stage(self, s: int, stage: nn.Sequential, x):
        pipe = self._pipeline
        if pipe is None or s not in pipe["stages"]:
            return stage(x)
        if stage.training:
            raise NotImplementedError(f"a pipelined stage in training mode: {MESH_TODO}")
        with torch.no_grad():  # no gradient crosses the ranks
            return pipeline_blocks(list(stage), x, pipe["mesh"], pipe["axis"], pipe["M"])


def resolve_pipeline_carrier(model) -> Optional[BlockStageExec]:
    """The module carrying the stage engine: ``model.backbone`` for the MSCAN
    family (SegNeXt too), the model itself for ConvNeXt, else None."""
    backbone = getattr(model, "backbone", None)
    if hasattr(backbone, "enable_pipeline"):
        return backbone
    if hasattr(model, "enable_pipeline"):
        return model
    return None

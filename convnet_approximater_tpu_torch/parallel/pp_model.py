"""Whole-model pipeline partitioning, heterogeneous GPipe (port of the eval
half of ``convnet_approximater_tpu/parallel/pp_model.py``).

:func:`pipeline_blocks` pipelines the identical blocks inside one stage; this
module pipelines the whole model: ``model.pipeline_units()`` decomposes it
into an ordered list of units (stem, each block, each norm, the head) whose
sequential composition is the eval forward, :func:`partition_units` groups
them into ``n`` contiguous stages of least maximal cost (the same exact DP),
and the same ``M + n - 1`` step schedule runs them, stage ``k`` on pipe rank
``k``.  Three differences from the JAX package, by design:

* a unit's cost is its multiply-accumulates counted from shapes, as
  ``ModelAnalysis`` counts them (``hooks/model_analysis.py::count_macs``);
  the JAX package reads XLA's ``cost_analysis``;
* stage ``k``'s rank holds only its units' weights: the others are released
  on its device (``pp.release``) until :meth:`ModelPipeline.close` restores
  them;
* activations cross each boundary as a tensor of that boundary's own shape,
  found once by a shape pass: point-to-point sends need no padded flat
  carrier.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .mesh import MODEL_AXIS, axis_ranks
from .pp import gpipe, layout, release, restore
from .spatial import is_spatial, refuse_spatial

__all__ = ["Unit", "subtree", "unit_from_module", "partition_units", "build_model_pipeline",
           "ModelPipeline"]


class Unit(NamedTuple):
    """One pipeline-able piece of a model: ``module(h) -> h``."""
    name: str
    module: nn.Module


def subtree(module: nn.Module, *path) -> Optional[nn.Module]:
    """``module.p0.p1...``, or None where the path names no submodule."""
    node = module
    for p in path:
        node = getattr(node, "_modules", {}).get(str(p))
        if node is None:
            return None
    return node


def unit_from_module(name: str, module: nn.Module) -> Unit:
    """A Unit that runs ``module``'s forward."""
    return Unit(name, module)


class Tail(nn.Module):
    """Global average pooling, then ``head`` (a Sequential of what follows it):
    the last unit of a classifier."""

    def __init__(self, *head: nn.Module):
        super().__init__()
        self.head = nn.Sequential(*head)

    def forward(self, h):
        return self.head(h.mean(dim=(2, 3)))


def partition_units(costs: Sequence[float], n: int) -> List[List[int]]:
    """Contiguous partition of ``costs`` into ``n`` groups minimizing the
    max group sum (exact O(U^2 n) DP: the classic linear partition)."""
    u = len(costs)
    if n > u:
        raise ValueError(f"cannot split {u} units into {n} stages")
    prefix = np.concatenate([[0.0], np.cumsum(costs)])
    INF = float("inf")
    best = np.full((u + 1, n + 1), INF)
    cut = np.zeros((u + 1, n + 1), dtype=int)
    best[0, 0] = 0.0
    for k in range(1, n + 1):
        for j in range(k, u + 1):
            for i in range(k - 1, j):
                c = max(best[i, k - 1], prefix[j] - prefix[i])
                if c < best[j, k]:
                    best[j, k], cut[j, k] = c, i
    groups, j = [], u
    for k in range(n, 0, -1):
        i = cut[j, k]
        groups.append(list(range(i, j)))
        j = i
    return groups[::-1]


class ModelPipeline:
    """The whole-model pipeline on this rank: call it on an NCHW batch of the
    planned shape for the eval forward (autograd off, so the kernel layers take
    their kernels); :meth:`close` gives the model back its released weights."""

    def __init__(self, units, groups, shapes, mesh, axis, num_microbatches):
        self.mesh, self.axis, self.M = mesh, axis, num_microbatches
        index, _, _, _ = axis_ranks(mesh, axis)
        self.own = [units[i].module for i in groups[index]]
        self.stage_in, self.stage_out = shapes[groups[index][0]], shapes[groups[index][-1] + 1]
        self.y_mb = shapes[-1]
        self.x_mb = shapes[0]
        mine = set(groups[index])
        self._saved = [(units[i].module, release(units[i].module))
                       for i in range(len(units)) if i not in mine]

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) != (self.x_mb[0][0] * self.M,) + self.x_mb[0][1:]:
            raise ValueError(f"ModelPipeline: planned for a batch of {self.M} x "
                             f"{self.x_mb[0]}, got {tuple(x.shape)}")

        def stage_fn(h, j):
            for module in self.own:
                h = module(h)
            return h

        shape, dtype, order = self.y_mb
        return gpipe(stage_fn, x, self.mesh, self.axis, self.M, self.stage_in, self.stage_out,
                     ((shape[0] * self.M,) + shape[1:], dtype, order))

    def close(self):
        """Restore every released unit's weights (idempotent)."""
        for module, saved in self._saved:
            restore(module, saved)
        self._saved = []


@torch.no_grad()
def build_model_pipeline(model: nn.Module, x_shape, mesh, axis: str = MODEL_AXIS,
                         num_microbatches: int = None, dtype=torch.float32):
    """Set up the whole-model pipeline of ``model`` (in eval mode) for inputs of
    NHWC ``x_shape`` over ``mesh``'s ``axis`` (``n`` stages) in ``M``
    microbatches (default ``n``).

    Returns ``(apply_fn, report)``: ``apply_fn`` (a :class:`ModelPipeline`)
    takes the NCHW ``channels_last`` batch and returns the logits on every
    pipe rank; ``report`` lists each stage's units, MACs and share of them.
    Every rank plans from the whole model: one shape pass over the units at the
    microbatch's shape counts each unit's MACs and records each boundary's
    shape, type and memory layout.  Then each rank releases the units of the other stages.
    """
    from convnet_approximater_tpu_torch.hooks.model_analysis import count_macs

    if not hasattr(model, "pipeline_units"):
        raise TypeError(f"{type(model).__name__} has no pipeline_units()")
    if is_spatial(model):
        raise refuse_spatial("a pipeline (pipeline_parallel > 1) of a spatially sharded model")
    _, n, _, _ = axis_ranks(mesh, axis)
    units = model.pipeline_units()
    M = int(num_microbatches or n)
    B, H, W, C = x_shape
    if B % M:
        raise ValueError(f"batch {B} % microbatches {M} != 0")
    device = next(model.parameters()).device
    h = torch.zeros(B // M, C, H, W, device=device, dtype=dtype).contiguous(
        memory_format=torch.channels_last)
    shapes, costs = [layout(h)], []
    for unit in units:
        costs.append(float(count_macs(unit.module, h)))
        h = unit.module(h)
        shapes.append(layout(h))
    groups = partition_units(costs, n)
    total = sum(costs) or 1.0
    report = [dict(stage=k, units=[units[i].name for i in g], macs=sum(costs[i] for i in g),
                   share=sum(costs[i] for i in g) / total)
              for k, g in enumerate(groups)]
    return ModelPipeline(units, groups, shapes, mesh, axis, M), report

"""GPipe pipelining over the ranks of the mesh's ``model`` axis (port of the
eval half of ``convnet_approximater_tpu/parallel/pp.py``).

The JAX package stacks the per-block parameters of a stage and shards the
stack over the pipeline axis (``stack_shardings``), so device ``i`` holds
blocks ``[i L/n, (i+1) L/n)``, and rotates microbatches with
``lax.ppermute``.  Here pipe rank ``i`` is a process: it runs its own blocks,
receives each microbatch from rank ``i - 1`` and sends it on to rank ``i + 1``
(``irecv``/``isend``), and the blocks it does not own have had their weights
released on its device (:func:`release`).  That per-rank ownership is all that
is left of ``stack_shardings``.  The last stage's outputs are broadcast over
the pipe group at the end, in place of the JAX ``psum``, so every pipe rank
returns the whole batch.  The training form (``pipeline_blocks_train``) is
ROADMAP.md queue 1, item 12b.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from convnet_approximater_tpu_torch.nn import drop_weight_caches

from .mesh import MODEL_AXIS, axis_ranks

__all__ = ["pipeline_blocks", "owned_range", "release", "restore", "gpipe"]


def layout(h: torch.Tensor) -> tuple:
    """``(shape, dtype, order)`` of an activation: ``order`` lists its dims
    from the outermost in memory to the innermost (``(0, 2, 3, 1)`` for an
    NCHW ``channels_last`` map), so that a receiver rebuilds its strides and
    the next block runs on the layout the plain forward gives it."""
    order = tuple(sorted(range(h.dim()), key=lambda d: (-h.stride(d), d)))
    return tuple(h.shape), h.dtype, order


def _dense(h: torch.Tensor, order) -> torch.Tensor:
    """``h`` as a dense tensor to send, its dims in ``order`` (no copy when
    ``h`` is laid out so)."""
    return h.permute(order).contiguous()


def _empty(shape, dtype, order, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(buffer, activation)``: a dense buffer to receive into, and the
    activation of ``shape`` it holds, laid out in ``order``."""
    buf = torch.empty([shape[d] for d in order], dtype=dtype, device=device)
    return buf, buf.permute([order.index(d) for d in range(len(order))])


def gpipe(stage_fn: Callable, x: torch.Tensor, mesh, axis: str, num_microbatches: int,
          stage_in: tuple, stage_out: tuple, y_out: tuple) -> torch.Tensor:
    """The GPipe schedule on this rank: ``M + n - 1`` steps; at step ``t`` pipe
    rank ``i`` runs ``stage_fn`` on microbatch ``t - i`` (if there is one),
    taking it from ``x`` (rank 0) or from rank ``i - 1``, and passing it to rank
    ``i + 1`` (or keeping it, on the last rank).  ``stage_in`` and
    ``stage_out`` are the :func:`layout` of one microbatch entering and leaving
    this rank, ``y_out`` that of the whole batch's result, which every pipe
    rank returns."""
    index, n, group, ranks = axis_ranks(mesh, axis)
    M = num_microbatches
    xs = x.chunk(M)
    outs: List[torch.Tensor] = []
    sends = []
    for t in range(M + n - 1):
        j = t - index
        if not 0 <= j < M:
            continue
        if index == 0:
            h = xs[j]
        else:
            buf, h = _empty(*stage_in, x.device)
            dist.irecv(buf, src=ranks[index - 1], group=group).wait()
        out = stage_fn(h)
        if index < n - 1:
            dense = _dense(out, stage_out[2])
            sends.append((dist.isend(dense, dst=ranks[index + 1], group=group), dense))
        else:
            outs.append(out)
    for work, _ in sends:
        work.wait()
    if n == 1:
        return torch.cat(outs)
    if index == n - 1:
        y = torch.cat(outs)
        dist.broadcast(_dense(y, y_out[2]), src=ranks[-1], group=group)
        return y
    buf, y = _empty(*y_out, x.device)
    dist.broadcast(buf, src=ranks[-1], group=group)
    return y


def owned_range(L: int, mesh, axis: str = MODEL_AXIS) -> range:
    """The blocks ``[i L/n, (i+1) L/n)`` that pipe rank ``i`` owns."""
    index, n, _, _ = axis_ranks(mesh, axis)
    per = L // n
    return range(index * per, (index + 1) * per)


def structure(module: nn.Module) -> tuple:
    """The submodules' names and types and every parameter's and buffer's
    name, shape and type: blocks that share it form a stack."""
    return (tuple((name, type(m)) for name, m in module.named_modules()),
            tuple((name, tuple(t.shape), t.dtype) for name, t in
                  list(module.named_parameters()) + list(module.named_buffers())))


def pipeline_blocks(blocks: Sequence[nn.Module], x: torch.Tensor, mesh, axis: str = MODEL_AXIS,
                    num_microbatches: int = None) -> torch.Tensor:
    """Apply ``L`` structurally identical, shape-preserving blocks to ``x`` as
    an ``n``-stage pipeline over ``mesh``'s ``axis`` (``n`` its size), in
    ``M`` microbatches (default ``n``; ``B % M == 0``).  Equal to the blocks'
    sequential composition on each microbatch; pipe rank ``i`` runs only its
    own blocks (:func:`owned_range`), so the others may have been released.
    Returns the ``(B, ...)`` result on every pipe rank."""
    blocks = list(blocks)
    if not blocks:
        return x
    L = len(blocks)
    if any(structure(b) != structure(blocks[0]) for b in blocks[1:]):
        raise ValueError("pipeline_blocks: ragged block stack")
    _, n, _, _ = axis_ranks(mesh, axis)
    if L % n:
        raise ValueError(f"pipeline_blocks: {L} blocks don't split over {n} stages")
    M = int(num_microbatches or n)
    B = x.shape[0]
    if B % M:
        raise ValueError(f"pipeline_blocks: batch {B} % microbatches {M} != 0")
    own = [blocks[k] for k in owned_range(L, mesh, axis)]

    def stage_fn(h):
        for block in own:
            h = block(h)
        return h

    shape, dtype, order = layout(x)  # the blocks keep their input's shape and layout
    mb = (B // M,) + shape[1:]
    return gpipe(stage_fn, x, mesh, axis, M, (mb, dtype, order), (mb, dtype, order),
                 (shape, dtype, order))


def release(module: nn.Module) -> dict:
    """Free ``module``'s parameters and buffers on their device: each becomes
    a meta tensor of its shape, type and strides, and the kernel layers'
    per-weight-version caches within it are dropped, so nothing of its weights
    stays on the card.  Returns the host copies that :func:`restore` takes."""
    saved = {}
    for name, m in module.named_modules():
        for kind in ("_parameters", "_buffers"):
            store = getattr(m, kind)
            for key, t in store.items():
                if t is None or t.is_meta:
                    continue
                saved[(name, kind, key)] = (t.detach().cpu(), t.device, t.requires_grad)
                meta = torch.empty_like(t.detach(), device="meta")
                store[key] = (nn.Parameter(meta, requires_grad=t.requires_grad)
                              if kind == "_parameters" else meta)
    drop_weight_caches(module)
    return saved


def restore(module: nn.Module, saved: dict) -> nn.Module:
    """Put back on their devices the weights :func:`release` took."""
    for (name, kind, key), (t, device, requires_grad) in saved.items():
        value = t.to(device)
        getattr(module.get_submodule(name), kind)[key] = (
            nn.Parameter(value, requires_grad=requires_grad) if kind == "_parameters" else value)
    return module

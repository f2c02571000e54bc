"""GPipe pipelining over the ranks of the mesh's ``model`` axis (port of
``convnet_approximater_tpu/parallel/pp.py``).

The JAX package stacks the per-block parameters of a stage and shards the
stack over the pipeline axis (``stack_shardings``), so device ``i`` holds
blocks ``[i L/n, (i+1) L/n)``, and rotates microbatches with
``lax.ppermute``.  Here pipe rank ``i`` is a process: it runs its own blocks,
receives each microbatch from rank ``i - 1`` and sends it on to rank ``i + 1``
(``irecv``/``isend``), and the blocks it does not own have had their weights
released on its device (:func:`release`).  That per-rank ownership is all that
is left of ``stack_shardings``.  The last stage's outputs are broadcast over
the pipe group at the end, in place of the JAX ``psum``, so every pipe rank
returns the whole batch.

:func:`pipeline_blocks` is the eval form (no graph kept);
:func:`pipeline_blocks_train` the differentiable one, whose backward sends
each microbatch's input gradient back from rank ``i`` to rank ``i - 1``, the
transpose of the forward rotation, as ``jax.grad`` of the JAX pipeline does.

gloo has no point-to-point path for a card's tensors (its collectives stage
them through the host, its ``send``/``recv`` read the pointer they are given),
so on a gloo group a card's message travels through a pinned host buffer
(:func:`_isend`, :func:`_recv`): ranks sharing one card are gloo processes.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from convnet_approximater_tpu_torch.nn import drop_weight_caches

from .mesh import MODEL_AXIS, axis_ranks

__all__ = ["pipeline_blocks", "pipeline_blocks_train", "owned_range", "release", "restore",
           "gpipe"]

FORWARD_TAG, BACKWARD_TAG = 0, 1  # a gradient is never matched to an activation's receive


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


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a message of ``t`` over ``group`` goes through a host buffer: a
    card's tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _isend(t: torch.Tensor, dst: int, group, tag: int):
    """Start sending the dense tensor ``t`` to global rank ``dst``; returns
    ``(work, buffer)``: keep the buffer until the work is done."""
    if _staged(t, group):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)  # a synchronous copy: the bytes are on the host before the send
        t = host
    return dist.isend(t, dst=dst, group=group, tag=tag), t


def _recv(buf: torch.Tensor, src: int, group, tag: int) -> None:
    """Receive from global rank ``src`` into the dense tensor ``buf``."""
    if _staged(buf, group):
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        dist.irecv(host, src=src, group=group, tag=tag).wait()
        buf.copy_(host)
    else:
        dist.irecv(buf, src=src, group=group, tag=tag).wait()


def _broadcast_from(h: torch.Tensor, order, src: int, group) -> None:
    """Broadcast ``h`` (the source's) over ``group`` as a dense tensor in ``order``."""
    dist.broadcast(_dense(h, order), src=src, group=group)


def gpipe(stage_fn: Callable, x: torch.Tensor, mesh, axis: str, num_microbatches: int,
          stage_in: tuple, stage_out: tuple, y_out: tuple) -> torch.Tensor:
    """The GPipe schedule on this rank: ``M + n - 1`` steps; at step ``t`` pipe
    rank ``i`` runs ``stage_fn(h, j)`` on microbatch ``j = t - i`` (if there is one),
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
            _recv(buf, ranks[index - 1], group, FORWARD_TAG)
        out = stage_fn(h, j)
        if index < n - 1:
            sends.append(_isend(_dense(out, stage_out[2]), ranks[index + 1], group, FORWARD_TAG))
        else:
            outs.append(out)
    for work, _ in sends:
        work.wait()
    if n == 1:
        return torch.cat(outs)
    if index == n - 1:
        y = torch.cat(outs)
        _broadcast_from(y, y_out[2], ranks[-1], group)
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


def _checked(name: str, blocks: list, x: torch.Tensor, mesh, axis: str,
             num_microbatches: Optional[int]) -> Tuple[range, int]:
    """``(the blocks this rank owns, M)`` of a pipeline over ``blocks``; raises
    on a ragged stack, a stack the axis does not split or a batch the
    microbatches do not split."""
    L = len(blocks)
    if any(structure(b) != structure(blocks[0]) for b in blocks[1:]):
        raise ValueError(f"{name}: ragged block stack")
    _, n, _, _ = axis_ranks(mesh, axis)
    if L % n:
        raise ValueError(f"{name}: {L} blocks don't split over {n} stages")
    M = int(num_microbatches or n)
    B = x.shape[0]
    if B % M:
        raise ValueError(f"{name}: batch {B} % microbatches {M} != 0")
    return owned_range(L, mesh, axis), M


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
    own, M = _checked("pipeline_blocks", blocks, x, mesh, axis, num_microbatches)

    def stage_fn(h, j):
        for k in own:
            h = blocks[k](h)
        return h

    shape, dtype, order = layout(x)  # the blocks keep their input's shape and layout
    mb = (x.shape[0] // M,) + shape[1:]
    return gpipe(stage_fn, x, mesh, axis, M, (mb, dtype, order), (mb, dtype, order),
                 (shape, dtype, order))


class _TrainPipeline(torch.autograd.Function):
    """GPipe with a backward pass.  The forward keeps, per microbatch, the
    graph of this rank's blocks from a leaf input (the received activation, or
    rank 0's slice of ``x``) to its output; the backward takes the output
    gradient on the last pipe rank, runs back through the rank's blocks
    microbatch by microbatch (the last first), sends each input gradient to
    rank ``i - 1`` (a nested ``torch.autograd.backward``: the blocks'
    parameter gradients accumulate in their ``.grad``), and ends with pipe
    rank 0's input gradient broadcast over the pipe group: the replicated
    input's gradient is a sum over the pipe axis to which only stage 0
    contributes."""

    @staticmethod
    def forward(ctx, x, anchor, stage_fn, mesh, axis, M, mb, whole):
        kept = []

        def keeping(h, j):
            h = h.detach().requires_grad_()
            with torch.enable_grad():
                out = stage_fn(h, j)
            kept.append((h, out))
            return out.detach()

        ctx.kept, ctx.mesh, ctx.axis, ctx.mb, ctx.whole = kept, mesh, axis, mb, whole
        return gpipe(keeping, x.detach(), mesh, axis, M, mb, mb, whole)

    @staticmethod
    def backward(ctx, gy):
        index, n, group, ranks = axis_ranks(ctx.mesh, ctx.axis)
        kept, mb, whole = ctx.kept, ctx.mb, ctx.whole
        ctx.kept = None
        M = len(kept)
        gys = gy.chunk(M) if index == n - 1 else None
        dxs, sends = [None] * M, []
        for j in reversed(range(M)):
            h, out = kept[j]
            kept[j] = None  # the microbatch's graph goes with its backward
            if index == n - 1:
                g = gys[j]
            else:
                buf, g = _empty(*mb, gy.device)
                _recv(buf, ranks[index + 1], group, BACKWARD_TAG)
            torch.autograd.backward(out, g)
            del out
            if index > 0:
                sends.append(_isend(_dense(h.grad, mb[2]), ranks[index - 1], group,
                                    BACKWARD_TAG))
            else:
                dxs[j] = h.grad
        for work, _ in sends:
            work.wait()
        if index == 0:
            dx = torch.cat(dxs)
            if n > 1:
                _broadcast_from(dx, whole[2], ranks[0], group)
        else:
            buf, dx = _empty(*whole, gy.device)
            dist.broadcast(buf, src=ranks[0], group=group)
        return dx, None, None, None, None, None, None, None


def pipeline_blocks_train(blocks: Sequence[nn.Module], x: torch.Tensor, mesh,
                          axis: str = MODEL_AXIS, num_microbatches: int = None,
                          run_block: Callable = None) -> torch.Tensor:
    """:func:`pipeline_blocks` with a backward pass (port of JAX
    ``pipeline_blocks_train``): differentiable in ``x`` and in the parameters
    of this rank's blocks.  ``run_block(k, block, h, j)`` runs block ``k`` on
    microbatch ``j`` (default ``block(h)``): the stage engine draws the drop
    masks and keeps the BatchNorm updates per (block, microbatch) there.  With
    autograd off it is the forward alone, no graph kept.  Every pipe rank
    returns the ``(B, ...)`` result, and after the backward every pipe rank
    holds ``x``'s gradient (pipe rank 0's, broadcast)."""
    blocks = list(blocks)
    if not blocks:
        return x
    own, M = _checked("pipeline_blocks_train", blocks, x, mesh, axis, num_microbatches)
    run_block = run_block or (lambda k, block, h, j: block(h))

    def stage_fn(h, j):
        for k in own:
            h = run_block(k, blocks[k], h, j)
        return h

    shape, dtype, order = layout(x)
    mb = ((x.shape[0] // M,) + shape[1:], dtype, order)
    whole = (shape, dtype, order)
    if not torch.is_grad_enabled():
        return gpipe(stage_fn, x, mesh, axis, M, mb, mb, whole)
    # the anchor makes the output part of the graph even when x needs no gradient
    anchor = torch.zeros((), device=x.device, requires_grad=True)
    return _TrainPipeline.apply(x, anchor, stage_fn, mesh, axis, M, mb, whole)


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

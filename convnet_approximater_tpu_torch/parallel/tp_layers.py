"""The sharded layer forms of tensor parallelism: the collectives the JAX
package leaves to XLA, written out.

Under ``parallel/tp.py::shard_module`` a layer whose parameters a rule
shards holds only this rank's slice of them on the mesh's ``model`` axis,
and its forward becomes one of these forms, so that every rank of a model
group computes what one process computes on the whole model (every rank of
the group runs the same rows, so a loss is the same on each, and no
gradient of a replicated activation is summed twice):

* **column** (the output channels sharded: a conv, grouped or depthwise
  included, a ``Linear``, their int8 and QAT forms, BatchNorm's affine): the
  rank computes its output channels.  A replicated input enters through
  :class:`CopyToModel` (its gradient is the sum over the group of each
  rank's part), a grouped conv's through :class:`ScatterToModel` (the rank
  takes the input channels of its groups); the output leaves through
  :class:`GatherFromModel` (an ``all_gather`` over the channels), unless the
  next layer of a Megatron pair takes it sharded;
* **row** (the input channels sharded, ``groups == 1``): the rank takes its
  input channels (:class:`ScatterToModel`, or the pair's sharded activation
  as it is), computes the partial sum with no bias, ``all_reduce``s it
  (:class:`ReduceFromModel`) and adds the bias once;
* **local** (inside a pair: the depthwise conv or the BatchNorm between the
  two halves): the rank's channels in, its channels out, no collective; a
  port ``Dropout`` there takes the rank's columns of the mask one process
  draws (``nn.bernoulli_rows``);
* **gathered** (any other layout a rule may give, say a kernel's spatial
  axis): the layer ``all_gather``s its sharded parameters and runs whole
  (:class:`GatherFromModel` on the parameter, whose gradient is the rank's
  slice of the whole one).

The kernel layers read some weights outside their submodules' forwards
(``MSCA``'s channel mix, the strip bank's taps, ``LowRankExpConvV1``'s
mix): they build their per-weight-version caches inside
:func:`whole_weights`, which gathers the sharded parameters of a subtree for
the time of the build, so a kernel takes the whole weights and no collective
runs per call.  A ``pallas_call`` of the JAX package is not partitioned
either: XLA gathers its operands the same way.

Activations travel in their memory format (an ``NCHW`` map that is
``channels_last`` is gathered over its innermost dim); bfloat16 travels as
float32, which holds it exactly.
"""

from __future__ import annotations

import contextlib
import types
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["ModelAxis", "LeafTP", "CopyToModel", "ReduceFromModel", "ScatterToModel",
           "GatherFromModel", "all_gather_dim", "all_reduce_sum", "local_slice", "install",
           "uninstall", "whole_weights", "tp_forward"]


class ModelAxis(NamedTuple):
    """A rank's place on the mesh's ``model`` axis."""

    index: int  # this rank's index on the axis: it holds slice ``index`` of a sharded dim
    size: int  # the ranks on the axis
    group: object  # the axis's process group
    ranks: tuple  # the global rank of each index


class LeafTP:
    """What :func:`tp_forward` does for one layer: its ``role`` (``col``,
    ``row``, ``local`` or ``gathered``), the sharded dim of each of its direct
    parameters (None: replicated), how its input enters (``rep``, ``scatter``
    or ``local``) and its output leaves (``gather``, ``local`` or ``reduce``),
    and the channel dim of its activations (1 for a map, -1 for a ``Linear``).
    A copy of the model (the EMA, a teacher) shares it."""

    def __init__(self, role: str, dims: Dict[str, Optional[int]], axis: ModelAxis,
                 in_mode: str = "rep", out_mode: str = "gather", chan: int = 1):
        self.role, self.dims, self.axis = role, dict(dims), axis
        self.in_mode, self.out_mode, self.chan = in_mode, out_mode, chan

    def __deepcopy__(self, memo):
        return self

    def __repr__(self):
        return (f"LeafTP({self.role}, in={self.in_mode}, out={self.out_mode}, "
                f"dims={ {k: v for k, v in self.dims.items() if v is not None} })")


# -- collectives ---------------------------------------------------------------
def _channels_last(t: torch.Tensor) -> bool:
    return (t.dim() == 4 and not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last))


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a dense tensor of a type gloo and NCCL both reduce."""
    return (t.float() if t.dtype == torch.bfloat16 else t).contiguous()


def local_slice(t: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
    """This rank's contiguous slice of ``t`` along ``dim`` (a view)."""
    dim = dim % t.dim()
    n = t.shape[dim] // axis.size
    return t.narrow(dim, axis.index * n, n)


def all_gather_dim(t: torch.Tensor, dim: int, axis: ModelAxis) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order; a
    ``channels_last`` map gathered over its channels comes back
    ``channels_last``."""
    dim = dim % t.dim()
    if dim == 1 and _channels_last(t):
        return all_gather_dim(t.permute(0, 2, 3, 1), 3, axis).permute(0, 3, 1, 2)
    send = _wire(t)
    parts = [torch.empty_like(send) for _ in range(axis.size)]
    dist.all_gather(parts, send, group=axis.group)
    return torch.cat(parts, dim).to(t.dtype)


def all_reduce_sum(t: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """A new tensor: ``t`` summed over the axis, in ``t``'s memory format."""
    if _channels_last(t):
        return all_reduce_sum(t.permute(0, 2, 3, 1), axis).permute(0, 3, 1, 2)
    buf = _wire(t).clone()
    dist.all_reduce(buf, group=axis.group)
    return buf.to(t.dtype)


def _dense_like(t: torch.Tensor) -> torch.Tensor:
    """A dense copy of a slice, ``channels_last`` where the map was."""
    if t.dim() == 4 and t.shape[1] > 1 and t.stride(1) == 1:
        return t.contiguous(memory_format=torch.channels_last)
    return t.contiguous()


class CopyToModel(torch.autograd.Function):
    """A replicated input entering a sharded layer: the identity forward, and
    the sum over the model axis of each rank's gradient."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.axis), None


class ReduceFromModel(torch.autograd.Function):
    """A row layer's partial sums: summed over the model axis; the gradient
    goes to each rank as it is."""

    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class ScatterToModel(torch.autograd.Function):
    """A replicated tensor's slice along ``dim`` for this rank; the gradient of
    the whole is every rank's slice gradient, gathered."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _dense_like(local_slice(x, dim, axis))

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.axis), None, None


class GatherFromModel(torch.autograd.Function):
    """The whole tensor from every rank's slice along ``dim``; the gradient of
    this rank's slice is its part of the (replicated) whole gradient."""

    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return all_gather_dim(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _dense_like(local_slice(g, ctx.dim, ctx.axis)), None, None


# -- the layer forms -----------------------------------------------------------
@contextlib.contextmanager
def _swapped(module: nn.Module, params: Dict[str, Optional[torch.Tensor]] = None,
             attrs: Dict[str, object] = None):
    """Within the block ``module`` holds ``params`` in place of its own (as
    ``torch.func.functional_call`` swaps them) and ``attrs`` in place of its
    attributes."""
    params, attrs = params or {}, attrs or {}
    saved_p = {n: module._parameters[n] for n in params}
    saved_a = {n: module.__dict__.get(n) for n in attrs}
    module._parameters.update(params)
    module.__dict__.update(attrs)
    try:
        yield
    finally:
        module._parameters.update(saved_p)
        for n, v in saved_a.items():
            if v is None:
                module.__dict__.pop(n, None)
            else:
                module.__dict__[n] = v


def _weight_name(module: nn.Module) -> str:
    return "weight_q" if "weight_q" in module._parameters else "weight"


def _width_attrs(module: nn.Module, tp: LeafTP) -> Dict[str, object]:
    """The attributes a layer's own forward reads that a shard changes: a
    grouped conv's groups, an int8 layer's output (column) or input (row) width."""
    from convnet_approximater_tpu_torch.layers.quant import QuantConv2d, QuantLinear

    size = tp.axis.size
    attrs = {}
    if isinstance(module, nn.Conv2d) and module.groups > 1:
        attrs["groups"] = module.groups // size
    if tp.role == "col" and isinstance(module, QuantConv2d):
        attrs["out_channels"] = module.out_channels // size
    if tp.role == "col" and isinstance(module, QuantLinear):
        attrs["out_features"] = module.out_features // size
    if tp.role == "row" and isinstance(module, QuantLinear):
        attrs["in_features"] = module.in_features // size
    return attrs


def _enter(x: torch.Tensor, tp: LeafTP) -> torch.Tensor:
    if tp.in_mode == "rep":
        return CopyToModel.apply(x, tp.axis)
    if tp.in_mode == "scatter":
        return ScatterToModel.apply(x, tp.chan, tp.axis)
    return x


def _col(module: nn.Module, x: torch.Tensor, tp: LeafTP) -> torch.Tensor:
    params = {}
    for name in ("bias", "w_scale"):  # a replicated per-output vector: the rank's slice
        p = module._parameters.get(name)
        if p is not None and name in tp.dims and tp.dims[name] is None and p.dim() == 1:
            params[name] = ScatterToModel.apply(p, 0, tp.axis)
    with _swapped(module, params, _width_attrs(module, tp)):
        y = type(module).forward(module, _enter(x, tp))
    return GatherFromModel.apply(y, tp.chan, tp.axis) if tp.out_mode == "gather" else y


def _unit_scale(module: nn.Module) -> Optional[torch.Tensor]:
    """For an int8 layer on float32 maps, a per-output ``w_scale`` whose
    float32 product with the layer's ``act_scale`` is exactly 1, so that
    ``qmatmul`` returns its integer sums unscaled (exact in float32 below
    2^24); None where the map is not float32 or no such scale is found.
    Made once per ``act_scale`` value (one host read)."""
    import numpy as np

    from convnet_approximater_tpu_torch.layers.quant import _QuantBase

    if not isinstance(module, _QuantBase):
        return None
    a = module.act_scale.detach()
    key = (a.data_ptr(), a._version, a.device)
    cached = module.__dict__.get("_tp_unit")
    if cached is not None and cached[0] == key:
        return cached[1]
    a32 = np.float32(a.float().item())
    cands = [np.float32(1) / a32]  # the reciprocal, or one of its float32 neighbours
    up = down = cands[0]
    for _ in range(3):
        up, down = np.nextafter(up, np.float32(np.inf)), np.nextafter(down, np.float32(0))
        cands += [up, down]
    unit = next((c for c in cands if np.float32(a32 * c) == np.float32(1)), None)
    t = None if unit is None else torch.full_like(module.w_scale.detach(), float(unit))
    module.__dict__["_tp_unit"] = (key, t)
    return t


def _row(module: nn.Module, x: torch.Tensor, tp: LeafTP) -> torch.Tensor:
    """The partial sum over the rank's input channels, summed over the model
    axis, and the bias once.  An int8 layer on a float32 map sums its exact
    integer partials (``qmatmul`` with a unit dequant scale) and dequantizes
    the total as ``qmatmul`` does, so its output has the replicated layer's
    bits: a row shard whose partials were dequantized first would round
    differently and could flip the next layer's int8 rounding."""
    x = _enter(x, tp)
    bias = module._parameters.get("bias")
    params = {"bias": None} if bias is not None else {}
    unit = _unit_scale(module) if x.dtype == torch.float32 else None
    if unit is not None:
        scale = module.act_scale * module.w_scale
        params["w_scale"] = unit
    with _swapped(module, params, _width_attrs(module, tp)):
        y = type(module).forward(module, x)
    y = ReduceFromModel.apply(y, tp.axis)
    spatial = tp.chan == 1 and y.dim() == 4
    if unit is not None:
        y = y * (scale[:, None, None] if spatial else scale)
    if bias is None:
        return y
    return y + (bias.to(y.dtype)[:, None, None] if spatial else bias.to(y.dtype))


def _local(module: nn.Module, x: torch.Tensor, tp: LeafTP) -> torch.Tensor:
    with _swapped(module, None, _width_attrs(module, tp)):
        return type(module).forward(module, x)


def _gathered(module: nn.Module, args, kwargs, tp: LeafTP):
    params = {n: GatherFromModel.apply(module._parameters[n], d, tp.axis)
              for n, d in tp.dims.items() if d is not None}
    with _swapped(module, params):
        return type(module).forward(module, *args, **kwargs)


def tp_forward(self, *args, **kwargs):
    """The forward of a layer under tensor parallelism (:class:`LeafTP`)."""
    tp = self.__dict__["_tp"]
    if tp.role == "gathered":
        return _gathered(self, args, kwargs, tp)
    (x,) = args
    if tp.role == "col":
        return _col(self, x, tp)
    if tp.role == "row":
        return _row(self, x, tp)
    return _local(self, x, tp)


def install(module: nn.Module, tp: LeafTP) -> None:
    """Give ``module`` the form ``tp`` (its class stays: the kernel layers'
    ``type(...) is Conv2d`` checks still see it)."""
    module.__dict__["_tp"] = tp
    module.__dict__["forward"] = types.MethodType(tp_forward, module)


def uninstall(module: nn.Module) -> None:
    module.__dict__.pop("_tp", None)
    module.__dict__.pop("forward", None)


@contextlib.contextmanager
def whole_weights(module: nn.Module):
    """Within the block every sharded parameter in ``module``'s subtree is
    the whole tensor, gathered over its model axis (detached: a kernel cache
    is built under ``no_grad``).  Collective over the model group; a no-op
    where nothing is sharded.  On leaving, the caches that submodules built
    from the gathered tensors are dropped (their keys name tensors that are
    gone)."""
    swaps: List[tuple] = []
    for name, m in module.named_modules():
        tp = m.__dict__.get("_tp")
        if tp is None or m.__dict__.get("_tp_whole"):  # whole already (a nested cache build)
            continue
        params = {n: all_gather_dim(m._parameters[n].detach(), d, tp.axis)
                  for n, d in tp.dims.items() if d is not None}
        if params:
            swaps.append((name, m, params))
    if not swaps:
        yield
        return
    with contextlib.ExitStack() as stack:
        for _, m, params in swaps:
            stack.enter_context(_swapped(m, params, {"_tp_whole": True}))
        yield
    touched = [name for name, _, _ in swaps]
    for name, m in module.named_modules():
        if m is module or not any(t == name or t.startswith(name + ".") for t in touched):
            continue
        m.__dict__.pop("_params_key", None)
        if hasattr(m, "drop_caches"):
            m.drop_caches()

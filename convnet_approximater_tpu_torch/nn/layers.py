"""Leaf layers (port of ``convnet_approximater_tpu/nn/layers.py``).

``Linear``, ``Identity``, ``ReLU``, ``GroupNorm`` and the pools are torch's
own: the JAX pools (``ops/conv.py``) use torch's bin edges and floor mode, and
the JAX ``GroupNorm`` normalises each sample's (H, W, C/G) group with its
biased variance and eps 1e-5, as torch's does (its ``scale`` is torch's
``weight``).  The layers below differ from torch's defaults where the JAX
package does:

* ``Conv2d`` is torch's with a ``pw_matmul`` flag (``deploy.enable_pw_matmul``
  sets it): an eval-mode 1x1 conv then runs as a matrix product over the NHWC
  view of its input;
* ``BatchNorm2d`` has no ``num_batches_tracked`` counter (the momentum is
  fixed, so the counter is never read), so its ``state_dict`` maps one to one
  onto the JAX params (``scale``/``bias``) and state (``mean``/``var``);
* ``LayerNorm`` normalises the channel axis of an NCHW map;
* the norms normalise a bfloat16 map in float32 and return bfloat16, as the
  JAX package's norms do (bf16 serving stays bf16 end to end), with no cast
  copy of the map: ``BatchNorm2d`` passes its affine parameters as float32
  beside its float32 running statistics (torch's mixed-type batch norm);
  ``LayerNorm`` and ``GroupNorm`` take parameters of the map's type (bf16
  after ``utils.dtype.cast_floating``), and torch's kernels accumulate a bf16
  map's statistics and affine in float32;
* ``GELU`` defaults to the tanh form, as the JAX package does;
* ``Dropout`` draws its training mask from its ``generator`` (one the trainer
  owns, seeded from the run's seed), not from torch's global generator.

Training across processes (``parallel/data_parallel.py``) runs each rank's
training forward inside :func:`sharded_batch`, which names the rank's place on
the data axis: there ``BatchNorm2d`` takes its batch statistics over the
whole global batch (an ``all_gather`` of each rank's count, mean and squared
deviations in the forward, an ``all_reduce`` of the two gradient sums in the
backward: the JAX package's batch norm over a global batch sharded on its
mesh), and the drop masks are drawn for the global batch, each rank taking
its rows (:func:`bernoulli_rows`), so the ranks compute what one process
computes on the whole batch.  Outside it, or over one rank, nothing changes.

Inside a pipelined stage in training (``models/stage_exec.py``) each
microbatch's ``BatchNorm2d`` normalizes by that microbatch's own statistics,
and :func:`microbatch_stats` collects each one's running-statistic update,
taken from the step's starting statistics; :meth:`MicrobatchStats.commit`
writes back their mean over the microbatches (the JAX pipeline's
``aux_acc += u / M``), where torch's momentum update in place would compound
M updates.

Modules take NCHW tensors; the model runs in ``torch.channels_last``, so an
NCHW tensor is an NHWC block of memory, the layout of the JAX package.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

Linear = nn.Linear
Identity = nn.Identity
ReLU = nn.ReLU
GroupNorm = nn.GroupNorm
MaxPool2d = nn.MaxPool2d
AdaptiveAvgPool2d = nn.AdaptiveAvgPool2d


class Conv2d(nn.Conv2d):
    """``torch.nn.Conv2d`` with the JAX ``Conv2d``'s ``pw_matmul`` opt-in.

    With ``pw_matmul`` set, an eval-mode forward of a pointwise conv (1x1,
    ``groups == 1``, stride 1, no padding, no dilation) is ``F.linear`` on the
    NHWC view ``x.permute(0, 2, 3, 1)``, which is a view when ``x`` is
    ``channels_last``; the result is permuted back to an NCHW tensor that is
    ``channels_last`` in memory.  Neither x nor y is copied, where cuDNN runs
    float32 1x1 convs on channels_last maps as NCHW kernels between two
    transposes.  It is the function of the conv, up to the order of the sums
    (``ops/conv.py::pointwise_matmul`` in the JAX package).  A training
    forward, and every other conv, takes torch's conv.  The JAX package gates
    the matmul to maps of at most 196 pixels, a measurement of XLA's; on an
    H100 in float32 the matmul beat cuDNN's conv at every 1x1 shape of MSCAN-t
    at batch 64 (``chip_smoke.py``'s 1x1 table, ``PERF.md``), so it takes no gate.
    """

    def __init__(self, *args, pw_matmul: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.pw_matmul = pw_matmul

    def is_pointwise(self) -> bool:
        return (self.kernel_size == (1, 1) and self.groups == 1 and self.stride == (1, 1)
                and self.padding == (0, 0) and self.dilation == (1, 1))

    def forward(self, x):
        if self.pw_matmul and not self.training and self.is_pointwise():
            y = F.linear(x.permute(0, 2, 3, 1), self.weight[:, :, 0, 0], self.bias)
            return y.permute(0, 3, 1, 2)
        return super().forward(x)


class Dropout(nn.Module):
    """Zero each element with probability ``p`` while training and scale the
    rest by ``1 / (1 - p)``, as ``torch.nn.Dropout``; the mask comes from
    ``generator`` (torch's global generator when it is None).  Between the
    two halves of a tensor-parallel pair (``parallel/tp.py``) its input is
    the rank's slice of the channels, and ``tp_slice`` (dim, index, count)
    makes it take that slice of the mask one process draws."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"dropout probability must be in [0, 1], got {p}")
        self.p = p
        self.generator = None
        self.tp_slice = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        if keep == 0.0:
            return torch.zeros_like(x)
        mask = bernoulli_rows(x, keep, self.generator, self.tp_slice)
        return x * mask / keep

    def extra_repr(self) -> str:
        return f"p={self.p}"


def channels_last(module: nn.Module) -> nn.Module:
    """Put every 4-d parameter and buffer of ``module`` in ``channels_last``, in
    place, and return it.  ``Module.to(memory_format=...)`` would refuse the
    5-d ``res_c`` of ``FixPaddingBias2d``."""
    return module._apply(
        lambda t: t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t)


def flatten_hwc(x):
    """Flatten an NCHW map per sample in (h, w, c) order, as the JAX package
    flattens its NHWC maps; a view when ``x`` is ``channels_last``."""
    return x.permute(0, 2, 3, 1).flatten(1)


class DataShard(NamedTuple):
    """A rank's place on the data axis of training across processes."""

    index: int  # this rank's index on the axis: it holds rows [index * b, (index + 1) * b)
    count: int  # the ranks on the axis
    group: object  # the axis's process group (the batch statistics, the gradients)
    host: object  # a gloo group over the same ranks, for host-side values (the stop flag)
    root: int  # the global rank of the axis's first rank (the weights' source)


_data_shard = contextvars.ContextVar("data_shard", default=None)


@contextlib.contextmanager
def sharded_batch(shard: Optional[DataShard]):
    """Within the block a training forward holds ``shard``'s rows of a global
    batch: ``BatchNorm2d`` reduces over the data axis and the drop masks are
    the global batch's rows.  None changes nothing."""
    token = _data_shard.set(shard)
    try:
        yield
    finally:
        _data_shard.reset(token)


def current_shard() -> Optional[DataShard]:
    """The data axis :func:`sharded_batch` names here, or None."""
    return _data_shard.get()


def bernoulli_rows(x, keep: float, generator, cols=None) -> torch.Tensor:
    """A Bernoulli(``keep``) mask of ``x``'s shape and type from ``generator``.
    Inside :func:`sharded_batch` it is this rank's rows of the mask drawn for
    the whole global batch (in ``x``'s memory format), so ranks seeded alike
    draw what one process draws.  ``cols`` (dim, index, count) says that ``x``
    is slice ``index`` of ``count`` along ``dim`` of the whole activation (a
    tensor-parallel rank's channels): the mask is drawn whole and sliced so."""
    shard = _data_shard.get()
    if shard is None and cols is None:
        return torch.empty_like(x).bernoulli_(keep, generator=generator)
    rows = x.shape[0]
    count = shard.count if shard is not None else 1
    shape = [rows * count] + list(x.shape[1:])
    if cols is not None:
        dim, index, n = cols
        dim %= x.dim()
        shape[dim] *= n
    fmt = (torch.channels_last if x.dim() == 4 and not x.is_contiguous()
           and x.is_contiguous(memory_format=torch.channels_last) else torch.contiguous_format)
    full = torch.empty(shape, dtype=x.dtype, device=x.device,
                       memory_format=fmt).bernoulli_(keep, generator=generator)
    if shard is not None:
        full = full[shard.index * rows:(shard.index + 1) * rows]
    if cols is not None:
        full = full.narrow(dim, index * x.shape[dim], x.shape[dim])
    return full


class MicrobatchStats:
    """The running-statistic updates of a pipelined stage's microbatches: each
    BatchNorm's sum of ``u_j / M`` over its microbatches ``j`` (``M`` the
    microbatches of the global batch), in the order they ran."""

    def __init__(self, count: int):
        self.count = count
        self.sums = {}

    @torch.no_grad()
    def add(self, norm: nn.Module, mean: torch.Tensor, var: torch.Tensor) -> None:
        m, v = mean / self.count, var / self.count
        prev = self.sums.get(norm)
        self.sums[norm] = (m, v) if prev is None else (prev[0] + m, prev[1] + v)

    @torch.no_grad()
    def commit(self, group=None, repeats: int = 1) -> None:
        """Write each BatchNorm's mean update into its running statistics.
        With a data axis ``group``, the sums are first summed over its ranks
        and divided by ``repeats``, the ranks that hold the same microbatch."""
        for norm, (m, v) in self.sums.items():
            if group is not None:
                both = torch.cat([m, v])
                dist.all_reduce(both, group=group)
                if repeats > 1:
                    both /= repeats
                m, v = both.chunk(2)
            norm.running_mean.copy_(m)
            norm.running_var.copy_(v)
        self.sums = {}


_microbatch_stats = contextvars.ContextVar("microbatch_stats", default=None)


@contextlib.contextmanager
def microbatch_stats(stats: Optional[MicrobatchStats]):
    """Within the block a training ``BatchNorm2d`` leaves its running
    statistics as they are and adds its update to ``stats`` (None changes
    nothing)."""
    token = _microbatch_stats.set(stats)
    try:
        yield
    finally:
        _microbatch_stats.reset(token)


class GlobalBatchNorm(torch.autograd.Function):
    """Training batch norm over the rows of every rank of a data axis, in
    float32.  The forward gathers each rank's count, per-channel mean and sum
    of squared deviations and combines them (Chan's parallel update: no
    cancellation of large squares), updates the running statistics with the
    global count's unbiased variance, and normalises; the backward sums the
    per-channel ``dy`` and ``dy * xhat`` over the ranks, so each rank's input
    gradient is that of the sum of every rank's loss.  The affine gradients
    stay this rank's: the gradient reduction sums them."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps, group):
        xf = x.float()
        c = xf.shape[1]
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        n = xf.numel() // c
        local = torch.cat([mean.new_full((1,), float(n)), mean, var * n])
        parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, local, group=group)
        stats = torch.stack(parts)
        counts, means, m2 = stats[:, :1], stats[:, 1:c + 1], stats[:, c + 1:]
        total = counts.sum()
        mean = (counts * means).sum(0) / total
        m2 = (m2 + counts * (means - mean) ** 2).sum(0)
        invstd = torch.rsqrt(m2 / total + eps)
        with torch.no_grad():
            running_mean.mul_(1 - momentum).add_(mean * momentum)
            running_var.mul_(1 - momentum).add_(m2 / (total - 1).clamp_min(1) * momentum)
        xhat = (xf - mean[None, :, None, None]) * invstd[None, :, None, None]
        ctx.save_for_backward(xhat, weight, invstd, total)
        ctx.group = group
        return (xhat * weight[None, :, None, None] + bias[None, :, None, None]).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        xhat, weight, invstd, total = ctx.saved_tensors
        dyf = dy.float()
        sum_dy = dyf.sum((0, 2, 3))
        sum_dy_xhat = (dyf * xhat).sum((0, 2, 3))
        sums = torch.cat([sum_dy, sum_dy_xhat])
        dist.all_reduce(sums, group=ctx.group)
        g_dy, g_dy_xhat = (sums / total).chunk(2)
        dx = (weight * invstd)[None, :, None, None] * (
            dyf - g_dy[None, :, None, None] - xhat * g_dy_xhat[None, :, None, None])
        return dx.to(dy.dtype), sum_dy_xhat, sum_dy, None, None, None, None, None


class BatchNorm2d(nn.Module):
    """BatchNorm over (N, H, W) with running stats (unbiased running var);
    while training inside :func:`sharded_batch` over more than one rank, over
    the (N, H, W) of the global batch (:class:`GlobalBatchNorm`); inside
    :func:`microbatch_stats`, its update goes there."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        shard = _data_shard.get()
        stats = _microbatch_stats.get() if self.training else None
        mean, var = self.running_mean, self.running_var
        if stats is not None:  # this microbatch's update, from the step's statistics
            mean, var = mean.clone(), var.clone()
        if self.training and shard is not None:
            y = GlobalBatchNorm.apply(x, _f32(self.weight), _f32(self.bias), mean, var,
                                      self.momentum, self.eps, shard.group)
        else:
            y = F.batch_norm(x, mean, var, _f32(self.weight), _f32(self.bias), self.training,
                             self.momentum, self.eps)
        if stats is not None:
            stats.add(self, mean, var)
        return y


def _f32(t):
    """A batch norm's affine parameter beside its float32 running statistics
    (bf16 after ``cast_floating``; a float64 one, on a float64 map, stays)."""
    return t if t is None or t.dtype == torch.float64 else t.float()


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the channel axis of an NCHW map."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps)

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def gelu(x, approximate: bool = True):
    """GELU, tanh form unless ``approximate=False``.

    ``CAT_EXACT_GELU`` selects the exact erf form, and ``CAT_FAST_GELU``
    (which wins) the tanh form, as in the JAX package.
    """
    exact = (not approximate) or bool(os.environ.get("CAT_EXACT_GELU"))
    if os.environ.get("CAT_FAST_GELU"):
        exact = False
    return F.gelu(x, approximate="none" if exact else "tanh")


class GELU(nn.Module):
    def __init__(self, approximate: bool = True):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return gelu(x, self.approximate)


_frozen_keys = contextvars.ContextVar("frozen_params_keys", default=False)


def params_key(module: nn.Module) -> tuple:
    """Address, version counter, shape and type of every parameter of ``module``:
    a cache key that changes whenever a parameter is replaced, moved or
    modified in place.  Inside :func:`frozen_params_keys` it is the key last
    computed for ``module``, the parameters unread."""
    if _frozen_keys.get():
        key = module.__dict__.get("_params_key")
        if key is None:
            raise RuntimeError(f"{type(module).__name__}: no per-weight-version cache was "
                               f"filled; run an eval forward before freezing the keys")
        return key
    key = tuple((p.data_ptr(), p._version, tuple(p.shape), p.dtype)
                for p in module.parameters())
    module.__dict__["_params_key"] = key
    return key


def drop_weight_caches(module: nn.Module):
    """Forget every per-weight-version cache within ``module``: each layer
    that keeps one (the kernels' packed weights and layouts, the border maps)
    forgets it in its ``drop_caches()``, and the next eval forward builds it
    again from the parameters it finds."""
    for m in module.modules():
        if hasattr(m, "drop_caches"):
            m.drop_caches()
        m.__dict__.pop("_params_key", None)


@contextlib.contextmanager
def frozen_params_keys():
    """Within the block, every per-weight-version cache (the kernels' packed
    weights, the border maps) is read as the last eval forward left it.  An
    export trace needs this: it swaps the parameters for FakeTensors, which
    have no address, and the exported program holds the cached layouts as its
    constants instead of packing them again on every call."""
    token = _frozen_keys.set(True)
    try:
        yield
    finally:
        _frozen_keys.reset(token)


def init_weights(module: nn.Module, generator: torch.Generator):
    """Draw the weights of ``module`` from ``generator``, with the JAX package's
    distributions: conv and linear weights and biases uniform in
    ``±1/sqrt(fan_in)`` (torch's kaiming-uniform with a = sqrt(5)); a submodule
    with its own ``init_weights(generator)`` draws its own parameters.  Norms
    and layer scales keep their constant initial values."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                bound = m.weight[0].numel() ** -0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif m is not module and hasattr(m, "init_weights"):
                m.init_weights(generator)

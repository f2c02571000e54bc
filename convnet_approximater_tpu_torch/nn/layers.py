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

Modules take NCHW tensors; the model runs in ``torch.channels_last``, so an
NCHW tensor is an NHWC block of memory, the layout of the JAX package.
"""

from __future__ import annotations

import contextlib
import contextvars
import os

import torch
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
    ``generator`` (torch's global generator when it is None)."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"dropout probability must be in [0, 1], got {p}")
        self.p = p
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        if keep == 0.0:
            return torch.zeros_like(x)
        mask = torch.empty_like(x).bernoulli_(keep, generator=self.generator)
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


class BatchNorm2d(nn.Module):
    """BatchNorm over (N, H, W) with running stats (unbiased running var)."""

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
        return F.batch_norm(x, self.running_mean, self.running_var, _f32(self.weight),
                            _f32(self.bias), self.training, self.momentum, self.eps)


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

"""Leaf layers (port of ``convnet_approximater_tpu/nn/layers.py``).

``Conv2d``, ``Linear``, ``Dropout``, ``Identity``, ``ReLU`` and the pools are
torch's own: the JAX pools (``ops/conv.py``) use torch's bin edges and floor
mode.  The layers below differ from torch's defaults where the JAX package does:

* ``BatchNorm2d`` has no ``num_batches_tracked`` counter (the momentum is
  fixed, so the counter is never read), so its ``state_dict`` maps one to one
  onto the JAX params (``scale``/``bias``) and state (``mean``/``var``);
* ``LayerNorm`` normalises the channel axis of an NCHW map;
* ``GELU`` defaults to the tanh form, as the JAX package does.

Modules take NCHW tensors; the model runs in ``torch.channels_last``, so an
NCHW tensor is an NHWC block of memory, the layout of the JAX package.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

Conv2d = nn.Conv2d
Linear = nn.Linear
Dropout = nn.Dropout
Identity = nn.Identity
ReLU = nn.ReLU
MaxPool2d = nn.MaxPool2d
AdaptiveAvgPool2d = nn.AdaptiveAvgPool2d


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
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            self.training, self.momentum, self.eps)


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


def params_key(module: nn.Module) -> tuple:
    """Address, version counter, shape and type of every parameter of ``module``:
    a cache key that changes whenever a parameter is replaced, moved or
    modified in place."""
    return tuple((p.data_ptr(), p._version, tuple(p.shape), p.dtype)
                 for p in module.parameters())


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

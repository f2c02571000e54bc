"""Parameter and MAC counts (port of ``convnet_approximater_tpu/hooks/model_analysis.py``).

The JAX hook logs XLA's post-fusion FLOP count of the compiled forward.  This
one counts multiply-accumulates of ``Conv2d`` and ``Linear`` from the shapes
of one eval forward.  A module that may run a kernel instead of its children
(``LowRankExpConvV1``, ``MSCA``, ``CascadeConv``, ``ParallelConv``) or has
none (``QuantConv2d``, ``QuantLinear``) gives its own count through
``macs(x_shape)`` whenever none of its children ran; ``torch.utils.flop_counter``
would not see a kernel launched through ctypes at all.
"""

from __future__ import annotations

import torch
from torch import nn

from convnet_approximater_tpu_torch.utils.logger import get_logger

from .hook import HOOK, Hook
from .inference_time_hook import nhwc_size


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


@torch.no_grad()
def count_macs(model: nn.Module, x: torch.Tensor) -> int:
    """Multiply-accumulates of ``model(x)`` in its Conv2d and Linear layers."""
    total = 0
    at_entry = {}

    def leaf(module, inputs, output):
        nonlocal total
        if isinstance(module, nn.Conv2d):
            kh, kw = module.kernel_size
            total += output.numel() * (module.in_channels // module.groups) * kh * kw
        else:
            total += output.numel() * module.in_features

    def enter(module, inputs):
        at_entry[id(module)] = total

    def leave(module, inputs, output):
        nonlocal total
        if total == at_entry.pop(id(module)):  # a kernel ran in place of the children
            total += module.macs(tuple(inputs[0].shape))

    handles = []
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            handles.append(m.register_forward_hook(leaf))
        elif hasattr(m, "macs"):
            handles += [m.register_forward_pre_hook(enter), m.register_forward_hook(leave)]
    try:
        model(x)
    finally:
        for h in handles:
            h.remove()
    return total


@HOOK.register_module()
class ModelAnalysis(Hook):
    def __init__(self, runner, priority, input_shape=(224, 224, 3), batch_size: int = 1):
        super().__init__(runner, priority)
        self.input_size = nhwc_size((batch_size,) + tuple(input_shape))
        self.forwards = 0
        self.result = None

    def after_run(self):
        B, H, W, C = self.input_size
        model = self.runner.model.eval()
        x = torch.zeros(B, C, H, W, device=self.runner.device).contiguous(
            memory_format=torch.channels_last)
        macs, params = count_macs(model, x), count_params(model)
        self.forwards = 1
        get_logger().info(
            f"Model MACs: {macs / 1e6:.2f} M (Conv2d and Linear multiply-accumulates counted "
            f"from the shapes of one forward at {tuple(self.input_size)} NHWC), "
            f"Params: {params / 1e6:.2f} M")
        self.result = dict(macs=macs, params=params)

"""Serving rewrites of a model (port of ``convnet_approximater_tpu/deploy.py``;
only ``quantize_int8`` so far)."""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional

import torch
from torch import nn

from convnet_approximater_tpu_torch.layers.quant import QuantConv2d, QuantLinear
from convnet_approximater_tpu_torch.models.switchable import set_submodule
from convnet_approximater_tpu_torch.nn import Conv2d, Linear


def quantize_int8(model: nn.Module, calib_batches: Iterable[torch.Tensor],
                  filter_fn: Optional[Callable[[str, nn.Module], bool]] = None,
                  linears: bool = True) -> int:
    """int8 post-training quantization of every dense conv, and of every
    ``Linear`` when ``linears``, for serving.  Returns the number of modules
    quantized.

    1. Calibrate: run the model in eval mode over ``calib_batches`` and take
       the largest absolute input value of each target.
    2. Rewrite: swap each target for a ``QuantConv2d`` / ``QuantLinear`` with
       per-channel int8 weights and the static input scale
       ``max(absmax, 1e-12) / 127``.

    Targets are exact types only (``type(m) is Conv2d`` with ``groups == 1``,
    or ``type(m) is Linear``): a subclass with its own forward would lose it,
    and depthwise strips stay as they are.  ``filter_fn(path, module)``
    narrows the set further.
    """
    targets = [(path, m) for path, m in model.named_modules()
               if ((type(m) is Conv2d and m.groups == 1) or (linears and type(m) is Linear))
               and (filter_fn is None or filter_fn(path, m))]
    if not targets:
        return 0

    # -- calibrate ---------------------------------------------------------
    absmax: Dict[str, torch.Tensor] = {}

    def observe(path):
        def hook(module, inputs):
            cur = inputs[0].detach().abs().amax().float()
            absmax[path] = cur if path not in absmax else torch.maximum(absmax[path], cur)
        return hook

    model.eval()
    handles = [m.register_forward_pre_hook(observe(path)) for path, m in targets]
    n_batches = 0
    try:
        with torch.no_grad():
            for x in calib_batches:
                model(x)
                n_batches += 1
    finally:
        for h in handles:
            h.remove()
    if n_batches == 0:
        raise ValueError("quantize_int8 needs at least one calibration batch")
    missing = [path for path, _ in targets if path not in absmax]
    if missing:
        raise RuntimeError(f"calibration never reached {missing}")

    # -- rewrite -----------------------------------------------------------
    for path, m in targets:
        act_scale = max(float(absmax[path]), 1e-12) / 127.0
        q = (QuantConv2d.from_conv(m, act_scale) if isinstance(m, Conv2d)
             else QuantLinear.from_linear(m, act_scale))
        set_submodule(model, path, q)
    return len(targets)

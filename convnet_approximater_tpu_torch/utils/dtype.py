"""Serving types (port of ``convnet_approximater_tpu/utils/dtype.py`` and of
``serving_dtype`` in ``classification/validate.py``).

bf16 inference is the reference's serving mode: :func:`cast_floating` casts a
model's floating parameters, while its buffers (BatchNorm's running
statistics, the NMF dictionary start ``nmf_init``, QAT observers) and the
int8 modules' parameters (``w_scale``, ``act_scale`` and the bias they add in
float32) stay as they are.  The norms then normalise in float32 and return
the activation's type, each conv adds its bias in the float32 accumulator and
rounds once, and the kernels read and write bf16 and compute in float32.
"""

from __future__ import annotations

import torch
from torch import nn

from convnet_approximater_tpu_torch.layers.quant import _QuantBase

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` (or a torch dtype) as a torch dtype."""
    if isinstance(name, torch.dtype) and name in DTYPES.values():
        return name
    if name not in DTYPES:
        raise ValueError(f"unsupported dtype {name!r}: float32 or bfloat16")
    return DTYPES[name]


def dtype_name(dtype) -> str:
    """The name the reports, tags and artifacts use: ``float32`` or ``bfloat16``."""
    return str(dtype_of(dtype)).rsplit(".", 1)[-1]


@torch.no_grad()
def cast_floating(model: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Cast every floating parameter of ``model`` to ``dtype`` in place (the
    ``Parameter`` objects stay, their data changes) and return ``model``.
    Buffers and the int8 modules' float32 scales and biases keep their type."""
    dtype = dtype_of(dtype)
    for module in model.modules():
        if isinstance(module, _QuantBase):
            continue
        for p in module.parameters(recurse=False):
            if p.is_floating_point() and p.dtype != dtype:
                p.data = p.data.to(dtype)
    return model


def serving_dtype(model: nn.Module) -> torch.dtype:
    """The input type of a serving surface: the type of its first floating
    parameter with two or more dimensions (a conv or Linear weight), so that an
    int8 surface with bf16 weights beside float32 scales reads bf16; else the
    first floating parameter's; else float32."""
    floats = [p for p in model.parameters() if p.is_floating_point()]
    for p in floats:
        if p.dim() >= 2:
            return p.dtype
    return floats[0].dtype if floats else torch.float32

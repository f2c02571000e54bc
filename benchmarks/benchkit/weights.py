"""Seeded dense weights, made on the model's device in one draw.

Every parameter and buffer of the dense model takes its slice of one uniform
draw from a generator on the device, mapped to its range:

* conv and linear weights ``U(-sqrt(3 / fan_in), +)`` (unit variance through
  the layer, so that every block moves the logits), their biases
  ``U(-1 / sqrt(fan_in), +)``;
* batch norms' scales and running variances ``U(0.5, 1.5)``, their shifts and
  running means ``U(-0.2, 0.2)``; layer norms' the same;
* any other parameter (the blocks' layer scales) ``U(0.5, 1.0)``.

The benchmark keeps its own copy, the reference's input; the program's model
is filled with the same values.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def _ranges(model: nn.Module):
    out = {}
    for prefix, m in model.named_modules():
        name = f"{prefix}." if prefix else ""
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            out[name + "weight"] = (-(3 / fan_in) ** 0.5, (3 / fan_in) ** 0.5)
            if m.bias is not None:
                out[name + "bias"] = (-fan_in ** -0.5, fan_in ** -0.5)
        elif isinstance(m, nn.LayerNorm) or hasattr(m, "running_mean"):
            out[name + "weight"] = (0.5, 1.5)
            out[name + "bias"] = (-0.2, 0.2)
            if hasattr(m, "running_mean"):
                out[name + "running_mean"] = (-0.2, 0.2)
                out[name + "running_var"] = (0.5, 1.5)
    return out


@torch.no_grad()
def fill(model: nn.Module, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Fill ``model``'s state in place from ``generator`` (on the model's
    device); return a contiguous copy of it by name."""
    ranges = _ranges(model)
    state = model.state_dict(keep_vars=True)
    unknown = [k for k, t in state.items() if k not in ranges and t.dim() != 1]
    if unknown:
        raise ValueError(f"no range for {unknown}")
    total = sum(t.numel() for t in state.values())
    device = next(iter(state.values())).device
    u = torch.rand(total, generator=generator, device=device)
    at = 0
    for k, t in state.items():
        lo, hi = ranges.get(k, (0.5, 1.0))
        t.copy_((lo + (hi - lo) * u[at:at + t.numel()]).view(t.shape))
        at += t.numel()
    return {k: t.detach().clone().contiguous() for k, t in state.items()}

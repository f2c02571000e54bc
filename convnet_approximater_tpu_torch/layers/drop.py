"""Stochastic depth (port of ``convnet_approximater_tpu/layers/drop.py``)."""

from __future__ import annotations

import torch
from torch import nn


def drop_path(x, drop_prob: float, training: bool, scale_by_keep: bool = True):
    """Drop whole residual paths per sample while training."""
    if not training or drop_prob == 0.0:
        return x
    keep_prob = 1.0 - drop_prob
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = torch.empty(shape, dtype=x.dtype, device=x.device).bernoulli_(keep_prob)
    if scale_by_keep and keep_prob > 0.0:
        mask = mask / keep_prob
    return x * mask


class DropPath(nn.Module):
    def __init__(self, drop_prob: float = 0.0, scale_by_keep: bool = True):
        super().__init__()
        self.drop_prob = drop_prob
        self.scale_by_keep = scale_by_keep

    def forward(self, x):
        return drop_path(x, self.drop_prob, self.training, self.scale_by_keep)

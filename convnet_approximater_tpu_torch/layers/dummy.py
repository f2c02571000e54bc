"""No-op layer for pipeline smoke runs (port of ``convnet_approximater_tpu/layers/dummy.py``)."""

from __future__ import annotations

from torch import nn

from .substitution import LAYER


@LAYER.register_module()
class DummyLayer(nn.Module):
    def forward(self, x):
        return x

"""``SimpleConv``: the LAYER registry's name for the port's ``Conv2d`` (port of
``convnet_approximater_tpu/layers/simple_conv.py``), which already takes the
reference ``SimpleConv``'s constructor arguments."""

from __future__ import annotations

from convnet_approximater_tpu_torch.nn import Conv2d

from .substitution import LAYER

SimpleConv = LAYER.register_module(name="SimpleConv", module=Conv2d)

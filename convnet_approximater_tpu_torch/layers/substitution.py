"""A module holding both the original and its replacement (port of
``convnet_approximater_tpu/layers/substitution.py``).

``use_old`` routes the forward; ``switch_new`` / ``switch_old`` drop the other
branch.  Capturing outputs for fine-tuning is not ported yet.
"""

from __future__ import annotations

from torch import nn

from convnet_approximater_tpu_torch.utils.registry import Registry, build_from_cfg


class Substitution(nn.Module):
    def __init__(self, old_module: nn.Module, new_module: nn.Module, use_old: bool = True):
        super().__init__()
        self.old = old_module
        self.new = new_module
        self.use_old = use_old

    @property
    def old_module(self) -> nn.Module:
        return self.old

    @property
    def new_module(self) -> nn.Module:
        return self.new

    def switch_new(self, remove_old: bool = True):
        self.use_old = False
        if remove_old and "old" in self._modules:
            del self.old

    def switch_old(self, remove_new: bool = False):
        self.use_old = True
        if remove_new and "new" in self._modules:
            del self.new

    def forward(self, x):
        return self.old(x) if self.use_old else self.new(x)


LAYER = Registry("LAYER")


def build_layer(cfg, **kwargs) -> nn.Module:
    return build_from_cfg(cfg, LAYER, **kwargs)

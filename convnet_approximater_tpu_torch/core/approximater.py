"""Approximater template: initialize / optimize / postprocess (port of
``convnet_approximater_tpu/core/approximater.py``).

``initialize`` builds the target module from ``_get_tgt_args`` via the LAYER
registry, draws its weights from the caller's generator, puts it on the
source's device, wraps both in a :class:`Substitution` and carries invariant
weights across (``_fix_substitution``); ``optimize`` solves the target's
weights in place; ``postprocess`` unwraps; ``rewind`` resets an app's per-site
cursors for another pass over the same sites.

With ``deploy=True`` ``initialize`` returns the bare target, carried weights
included, with no ``Substitution``: the served form of a compressed model,
whose solved weights come from its checkpoint.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, Optional

import torch
from torch import nn

from convnet_approximater_tpu_torch.layers import LAYER, Substitution, build_layer
from convnet_approximater_tpu_torch.nn import init_weights
from convnet_approximater_tpu_torch.utils.registry import Registry, build_from_cfg


class Approximater(ABC):
    _src_type = ""
    _tgt_type = ""

    def __init__(self, deploy: bool = False):
        self.deploy = deploy

    @property
    def src_type(self) -> type:
        return self._src_type if isinstance(self._src_type, type) else LAYER.get(self._src_type)

    @property
    def tgt_type(self) -> type:
        return self._tgt_type if isinstance(self._tgt_type, type) else LAYER.get(self._tgt_type)

    @abstractmethod
    def _get_tgt_args(self, src: nn.Module) -> Dict:
        ...

    @abstractmethod
    def _fix_substitution(self, sub: Substitution, generator: torch.Generator):
        """Carry invariant weights from ``sub.old`` into ``sub.new`` (in place);
        new submodules draw their weights from ``generator``."""

    def initialize(self, src: nn.Module, generator: Optional[torch.Generator] = None):
        if not isinstance(src, self.src_type):
            raise TypeError(f"{type(src).__name__} is not {self.src_type.__name__}")
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        cfg = dict(type=self.tgt_type)
        cfg.update(self._get_tgt_args(src))
        tgt = build_layer(cfg)
        init_weights(tgt, generator)
        sub = Substitution(src, tgt)
        self._fix_substitution(sub, generator)
        param = next(src.parameters(), None)
        if param is not None:
            sub.new.to(param.device)
        if self.deploy:
            return sub.new
        return sub

    @abstractmethod
    def optimize(self, sub: Substitution):
        """Solve for the new module's weights, in place."""

    @abstractmethod
    def _postprocess(self, sub: Substitution):
        ...

    def postprocess(self, sub: Substitution) -> nn.Module:
        self._postprocess(sub)
        return sub.new_module

    def rewind(self):
        """Reset the per-site cursors (none here)."""


APP = Registry("APP")


def build_app(cfg, **kwargs) -> Approximater:
    return build_from_cfg(cfg, APP, **kwargs)

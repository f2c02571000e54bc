"""No-op approximater (port of ``convnet_approximater_tpu/core/dummy.py``): the
pipeline runs its phases against :class:`DummyLayer` sites, so on a model
without any only the hooks do work."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from convnet_approximater_tpu_torch.layers import Substitution

from .approximater import APP, Approximater


@APP.register_module()
class Dummy(Approximater):
    _src_type = "DummyLayer"
    _tgt_type = "DummyLayer"

    def __init__(self, deploy: bool = False):
        if deploy:
            raise NotImplementedError(
                "Dummy(deploy=True): the port's Approximater has no deploy mode yet "
                "(ROADMAP.md queue 1 item 9)")

    def _get_tgt_args(self, src: nn.Module) -> Dict:
        return {}

    def _fix_substitution(self, sub: Substitution, generator: torch.Generator):
        pass

    def optimize(self, sub: Substitution):
        pass

    def _postprocess(self, sub: Substitution):
        pass

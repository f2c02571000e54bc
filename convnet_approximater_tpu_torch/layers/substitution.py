"""A module holding both the original and its replacement (port of
``convnet_approximater_tpu/layers/substitution.py``).

``use_old`` routes the forward; ``switch_new`` / ``switch_old`` drop the other
branch.  Fine-tuning adds two things:

* ``capture``: a captured Substitution keeps the output of its last forward
  in ``out``; :func:`taps` collects them under the JAX package's tap keys,
  ``<name>.out``;
* ``capture_inputs``: a Substitution with it set keeps the input of its last
  forward in ``inp``, which :func:`taps` returns as ``<name>.in`` (the JAX
  package's ``ctx.capture_inputs``; calibration reads it);
* ``force_branch``: when set (``"old"`` or ``"new"``) it routes the forward
  in place of ``use_old``.  :func:`forced_branch` sets it on every
  Substitution of a model for the length of a block and always resets it.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterator, Optional

import torch
from torch import nn

from convnet_approximater_tpu_torch.utils.registry import Registry, build_from_cfg

TAP_OUT = "out"
TAP_IN = "in"


class Substitution(nn.Module):
    def __init__(self, old_module: nn.Module, new_module: nn.Module, use_old: bool = True):
        super().__init__()
        self.old = old_module
        self.new = new_module
        self.use_old = use_old
        self.capture = False
        self.capture_inputs = False
        self.force_branch: Optional[str] = None
        self.out: Optional[torch.Tensor] = None
        self.inp: Optional[torch.Tensor] = None

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
        branch = self.force_branch or ("old" if self.use_old else "new")
        if self.capture_inputs:
            self.inp = x
        y = self.old(x) if branch == "old" else self.new(x)
        if self.capture:
            self.out = y
        return y


def taps(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The outputs the captured Substitutions of ``model`` kept from its last
    forward, keyed ``<name>.out`` as the JAX package's taps are, and the inputs
    of those capturing inputs, keyed ``<name>.in``."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, Substitution):
            if m.capture and m.out is not None:
                out[f"{name}.{TAP_OUT}"] = m.out
            if m.capture_inputs and m.inp is not None:
                out[f"{name}.{TAP_IN}"] = m.inp
    return out


def release_taps(model: nn.Module):
    """Drop the outputs and inputs the Substitutions of ``model`` keep (and the
    autograd graph they hold)."""
    for m in model.modules():
        if isinstance(m, Substitution):
            m.out = m.inp = None


@contextmanager
def forced_branch(model: nn.Module, branch: str) -> Iterator[None]:
    """Route every Substitution of ``model`` down ``branch`` inside the block."""
    if branch not in ("old", "new"):
        raise ValueError(f"branch must be 'old' or 'new', got {branch!r}")
    subs = [m for m in model.modules() if isinstance(m, Substitution)]
    for m in subs:
        m.force_branch = branch
    try:
        yield
    finally:
        for m in subs:
            m.force_branch = None


LAYER = Registry("LAYER")


def build_layer(cfg, **kwargs) -> nn.Module:
    return build_from_cfg(cfg, LAYER, **kwargs)

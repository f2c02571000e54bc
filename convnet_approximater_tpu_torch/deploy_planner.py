"""The approximation loop outside the Runner (port of ``apply_app`` in
``convnet_approximater_tpu/deploy_planner.py``; the serving planner is not
ported yet)."""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch
from torch import nn

from convnet_approximater_tpu_torch.core import Approximater
from convnet_approximater_tpu_torch.filters import ModuleFilter
from convnet_approximater_tpu_torch.nn import channels_last


def apply_app(model: nn.Module, app: Approximater, filters: Sequence[ModuleFilter] = (),
              generator: Optional[torch.Generator] = None,
              calib_batches: Optional[Iterable[torch.Tensor]] = None) -> int:
    """Register -> initialize -> optimize -> postprocess ``app`` on ``model`` in
    place, one site after another; returns the number of sites rewritten (0
    when the app found none).

    The new modules draw their random weights from ``generator`` (seed 0 when
    None) before the solve overwrites them, land on their source's device and
    training mode, and keep the model's ``channels_last`` weights.  The
    data-driven branch of the JAX function (``calib_batches``) is not ported.
    """
    if calib_batches is not None:
        raise NotImplementedError(
            "apply_app: calib_batches (the data-driven solve) comes with the calibration "
            "hook, ROADMAP.md queue 1 item 7 (hooks/calibration.py)")
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    model.register_switchable(app.src_type, list(filters))
    for idx in range(model.length_switchable):
        src = model.get_switchable_module(idx)
        sub = app.initialize(src, generator).train(src.training)
        model.set_switchable_module(idx, sub)
        app.optimize(sub)
        model.set_switchable_module(idx, channels_last(app.postprocess(sub)))
    return model.length_switchable

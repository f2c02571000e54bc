"""The approximation loop outside the Runner (port of ``apply_app`` in
``convnet_approximater_tpu/deploy_planner.py``, with its calibration pass; the
serving planner is not ported yet)."""

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

    With ``calib_batches`` and an app that has ``set_calibration``, the loop
    takes the Runner's two-pass shape instead: initialize every site, run the
    batches down the ``old`` branches tapping each site's input
    (:func:`~convnet_approximater_tpu_torch.hooks.calibration.calibrate`, the
    work of ``CalibrationHook``), then optimize and postprocess each site.

    The new modules draw their random weights from ``generator`` (seed 0 when
    None) before the solve overwrites them, land on their source's device and
    training mode, and keep the model's ``channels_last`` weights.
    """
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    model.register_switchable(app.src_type, list(filters))
    n = model.length_switchable
    if calib_batches is None or not hasattr(app, "set_calibration"):
        for idx in range(n):
            src = model.get_switchable_module(idx)
            sub = app.initialize(src, generator).train(src.training)
            model.set_switchable_module(idx, sub)
            app.optimize(sub)
            model.set_switchable_module(idx, channels_last(app.postprocess(sub)))
        return n

    from convnet_approximater_tpu_torch.hooks.calibration import calibrate

    subs = []
    for idx in range(n):
        src = model.get_switchable_module(idx)
        sub = app.initialize(src, generator).train(src.training)
        model.set_switchable_module(idx, sub)
        subs.append(sub)
    calibrate(model, app, calib_batches)
    for idx, sub in enumerate(subs):
        app.optimize(sub)
        model.set_switchable_module(idx, channels_last(app.postprocess(sub)))
    return n

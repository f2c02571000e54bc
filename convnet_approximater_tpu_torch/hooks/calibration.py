"""Calibration: per-site input statistics for the data-driven solves (port of
``convnet_approximater_tpu/hooks/calibration.py``).

After the sites are initialized and before ``optimize``, a few calibration
batches go through the model's ``old`` branches in eval mode without
gradients; each Substitution's input is tapped (``<name>.in``) and reduced to
the statistic the app names in ``calibration_stat``, averaged over the
batches and handed to ``app.set_calibration(site, moment)``:

* ``strips``: the second moment of vertical (kh, 1) input strips, (C*kh)^2,
  flat index ``c*kh + u`` (scheme 2);
* ``patches``: of full (kh, kw) patches, (C*kh*kw)^2, flat index
  ``c*kh*kw + u*kw + v``, the order an OIHW kernel flattens to (V3);
* ``channels``: of single pixels, C^2 (V4);
* ``raw``: the tapped maps themselves, concatenated over the batches.

Strips and patches are unpadded windows: ``H - kh + 1`` rows (and ``W - kw +
1`` columns for patches) of every image, as the JAX package defines the
metric.  The taps are NCHW maps (``channels_last`` in memory); ``F.unfold``
lays the windows out in the JAX package's flat order.  Each image's
``cols @ cols^T`` is summed in float32, so no (samples, D) matrix of a whole
batch is built.
"""

from __future__ import annotations

from typing import Iterable, List

import torch
import torch.nn.functional as F
from torch import nn

from convnet_approximater_tpu_torch.data import Loader, Synthetic, build_dataset
from convnet_approximater_tpu_torch.layers import forced_branch, release_taps, taps
from convnet_approximater_tpu_torch.utils.logger import get_logger

from .hook import HOOK, Hook


def _window_moment(x: torch.Tensor, kernel_size) -> torch.Tensor:
    """Second moment of the unpadded stride-1 windows of ``x`` (B, C, H, W)."""
    x = x.float()
    acc, n = None, 0
    for b in range(x.shape[0]):
        cols = F.unfold(x[b:b + 1], kernel_size)[0]  # (C*kh*kw, L)
        part = cols @ cols.T
        acc = part if acc is None else acc + part
        n += cols.shape[1]
    return acc / n


@torch.no_grad()
def strip_second_moment(x: torch.Tensor, kh: int) -> torch.Tensor:
    """(C*kh, C*kh) second moment of the vertical strips of ``x`` (B, C, H, W)."""
    return _window_moment(x, (kh, 1))


@torch.no_grad()
def patch_second_moment(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """(C*kh*kw, C*kh*kw) second moment of the (kh, kw) patches of ``x``."""
    return _window_moment(x, (kh, kw))


@torch.no_grad()
def channel_second_moment(x: torch.Tensor) -> torch.Tensor:
    """(C, C) second moment of the pixels of ``x`` (B, C, H, W) over channels."""
    v = x.float().permute(0, 2, 3, 1).reshape(-1, x.shape[1])
    return (v.T @ v) / v.shape[0]


def site_statistic(stat: str, x: torch.Tensor, src: nn.Module) -> torch.Tensor:
    """One batch's statistic ``stat`` of a site's input ``x``; ``src`` (the
    site's old module) gives the kernel size."""
    if stat == "raw":
        return x
    kh, kw = getattr(src, "kernel_size", (1, 1))
    if stat == "patches":
        return patch_second_moment(x, kh, kw)
    if stat == "channels":
        return channel_second_moment(x)
    if stat == "strips":
        return strip_second_moment(x, kh)
    raise ValueError(f"unknown calibration statistic {stat!r}")


@torch.no_grad()
def calibrate(model: nn.Module, app, batches: Iterable[torch.Tensor]) -> List[int]:
    """Run ``batches`` through the ``old`` branches of ``model``'s switchable
    Substitutions (eval mode, no gradients), and hand each site's statistic,
    averaged over the batches (``raw``: concatenated), to
    ``app.set_calibration``.  Returns the sites calibrated."""
    subs = list(model.switchable_modules())
    keys = [f"{name}.in" for name in model.switchable_names]
    stat = getattr(app, "calibration_stat", "strips")
    acc: dict = {}
    count = 0
    was_training = model.training
    for sub in subs:
        sub.capture_inputs = True
    try:
        model.eval()
        with forced_branch(model, "old"):
            for x in batches:
                model(x)
                tapped = taps(model)
                for idx, key in enumerate(keys):
                    if key not in tapped:
                        continue
                    sm = site_statistic(stat, tapped[key], subs[idx].old_module)
                    if stat == "raw":
                        acc.setdefault(idx, []).append(sm)
                    else:
                        acc[idx] = acc[idx] + sm if idx in acc else sm
                release_taps(model)
                count += 1
    finally:
        for sub in subs:
            sub.capture_inputs = False
        release_taps(model)
        model.train(was_training)
    for idx, sm in acc.items():
        app.set_calibration(idx, torch.cat(sm, dim=0) if isinstance(sm, list)
                            else sm / max(count, 1))
    return sorted(acc)


@HOOK.register_module()
class CalibrationHook(Hook):
    """Calibrate a data-driven app after Initialize: ``num_batches`` batches of
    ``batch_size`` images at ``image_size`` from ``dataset`` (a DATASET
    registry config), or from ``Synthetic`` when none is given, through a
    ``Loader`` on the runner's device."""

    def __init__(self, runner, priority, num_batches: int = 2, batch_size: int = 8,
                 image_size=(64, 64), dataset=None):
        super().__init__(runner, priority)
        self.num_batches = num_batches
        self.batch_size = batch_size
        self.image_size = tuple(image_size)
        self.dataset_cfg = dataset
        self.calibrated: List[int] = []

    def after_initialize(self):
        runner = self.runner
        app = runner.app
        if not hasattr(app, "set_calibration"):
            get_logger().info("CalibrationHook: app has no set_calibration; skipped")
            return
        if self.dataset_cfg:
            ds = build_dataset(dict(self.dataset_cfg), split="train")
        else:
            ds = Synthetic(self.batch_size * self.num_batches, self.image_size + (3,), 10)
        loader = Loader(ds, self.batch_size, shuffle=False, image_size=self.image_size,
                        device=runner.device)
        batches = (images for _, (images, _) in zip(range(self.num_batches), loader))
        self.calibrated = calibrate(runner.model, app, batches)
        get_logger().info(f"CalibrationHook: collected moments for {self.calibrated}")

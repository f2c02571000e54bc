"""Mixup and CutMix on a batch on the device (port of
``convnet_approximater_tpu/data/mixup.py``).

The semantics are timm's, as in the JAX package: one Beta(alpha, alpha) lambda
per batch, a permutation of the batch as each sample's partner, CutMix's
target lambda corrected to the area actually pasted after the box is clipped
at the border, and ``switch_prob`` choosing CutMix over mixup when both are on.
Targets must already be dense (one-hot, or smoothed): mixing is linear, so
label smoothing composes.

The draws are kept apart from the arithmetic: :func:`draw_mix` draws a
:class:`MixDraw` (mode, lambda, partner permutation, box centre) from an
explicit ``torch.Generator`` on the host, and :func:`mixup_batch` /
:func:`cutmix_batch` apply given draws, so that a test can give both packages
the same permutation, lambda and box (their generators differ).  Images are
the ``Loader``'s NCHW batches; the box is over H and W.  The images mix in
their own type (lambda rounded to it, as the JAX package casts lambda to the
images' type), the targets in theirs.

Across processes a batch is one rank's rows of the global batch, and the
draw is the global batch's (the same seed on every rank): :func:`apply_mix`
with the data axis gathers the global batch and gives each of its rows the
partner the permutation gives it there, so the ranks' mixed rows are one
process's, bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from convnet_approximater_tpu_torch.parallel.data_parallel import all_gather_rows


class MixDraw(NamedTuple):
    cutmix: bool
    lam: float
    perm: torch.Tensor  # (B,) int64, the partner of each sample
    cy: int = 0  # CutMix box centre (row, column)
    cx: int = 0


def _partners(images, targets, perm, partners):
    if partners is not None:
        return partners
    perm = perm.to(images.device)
    return images[perm], targets[perm]


def mixup_batch(images: torch.Tensor, targets: torch.Tensor, lam, perm: torch.Tensor,
                partners=None):
    """Convex-combine each sample with its partner ``perm``: ``lam * x + (1 -
    lam) * x[perm]``, images and targets alike.  ``lam = 1`` is the identity.
    ``partners``, the partners' ``(images, targets)``, stands for ``x[perm]``
    where they are not in the batch."""
    p_images, p_targets = _partners(images, targets, perm, partners)
    lam_i = torch.tensor(float(lam), dtype=images.dtype, device=images.device)
    images = lam_i * images + (1.0 - lam_i) * p_images
    lam_t = torch.tensor(float(lam), dtype=targets.dtype, device=targets.device)
    targets = lam_t * targets + (1.0 - lam_t) * p_targets
    return images, targets


def cutmix_box(h: int, w: int, lam, cy: int, cx: int):
    """``(y0, y1, x0, x1, lam_actual)``: the box of side ratio ``sqrt(1 - lam)``
    centred at (cy, cx), clipped to the image, and the fraction of the image it
    leaves (in float32, as the JAX package computes them)."""
    f32 = np.float32
    cut_rat = np.sqrt(np.maximum(f32(0.0), f32(1.0) - f32(lam)))
    cut_h, cut_w = int(np.round(f32(h) * cut_rat)), int(np.round(f32(w) * cut_rat))
    y0, y1 = int(np.clip(cy - cut_h // 2, 0, h)), int(np.clip(cy + cut_h // 2, 0, h))
    x0, x1 = int(np.clip(cx - cut_w // 2, 0, w)), int(np.clip(cx + cut_w // 2, 0, w))
    lam_actual = f32(1.0) - f32((y1 - y0) * (x1 - x0)) / f32(h * w)
    return y0, y1, x0, x1, float(lam_actual)


def cutmix_batch(images: torch.Tensor, targets: torch.Tensor, lam, perm: torch.Tensor,
                 cy: int, cx: int, partners=None):
    """Paste the partner's pixels inside :func:`cutmix_box`'s box; the target
    weight is the exact fraction of pixels kept, even where the box clips the
    border.  ``partners`` as in :func:`mixup_batch`."""
    p_images, p_targets = _partners(images, targets, perm, partners)
    h, w = images.shape[2:]
    y0, y1, x0, x1, lam_actual = cutmix_box(h, w, lam, cy, cx)
    images = images.clone()
    images[:, :, y0:y1, x0:x1] = p_images[:, :, y0:y1, x0:x1]
    lam_t = torch.tensor(lam_actual, dtype=targets.dtype, device=targets.device)
    targets = lam_t * targets + (1.0 - lam_t) * p_targets
    return images, targets


def _beta(generator: torch.Generator, alpha: float) -> float:
    """One Beta(alpha, alpha) draw, as the ratio of two Gamma(alpha) draws."""
    g = torch._standard_gamma(torch.full((2,), float(alpha), dtype=torch.float64),
                              generator=generator)
    return float(g[0] / g.sum())


def draw_mix(generator: torch.Generator, batch: int, h: int, w: int, mixup_alpha: float = 0.0,
             cutmix_alpha: float = 0.0, switch_prob: float = 0.5) -> Optional[MixDraw]:
    """One step's draws (timm ``Mixup._params_per_batch``): with both alphas on,
    CutMix with probability ``switch_prob``, else mixup; lambda from the chosen
    mode's Beta(alpha, alpha); a partner permutation; for CutMix a box centre
    uniform over the image.  None, drawing nothing, when both alphas are 0.
    ``generator`` is a CPU generator."""
    if mixup_alpha > 0 and cutmix_alpha > 0:
        use_cutmix = bool(torch.rand((), generator=generator) < switch_prob)
    elif cutmix_alpha > 0 or mixup_alpha > 0:
        use_cutmix = cutmix_alpha > 0
    else:
        return None
    lam = _beta(generator, cutmix_alpha if use_cutmix else mixup_alpha)
    perm = torch.randperm(batch, generator=generator)
    if not use_cutmix:
        return MixDraw(False, lam, perm)
    cy = int(torch.randint(0, h, (), generator=generator))
    cx = int(torch.randint(0, w, (), generator=generator))
    return MixDraw(True, lam, perm, cy, cx)


def apply_mix(draw: Optional[MixDraw], images: torch.Tensor, targets: torch.Tensor,
              shard=None):
    """``draw`` applied to a batch; no draw passes the batch through.  With a
    data axis (``nn.DataShard``), ``images`` and ``targets`` are this rank's
    rows of the global batch that ``draw`` was drawn for, and their partners
    come from the global batch, gathered over the axis."""
    if draw is None:
        return images, targets
    partners = None
    if shard is not None:
        b = images.shape[0]
        idx = draw.perm[shard.index * b:(shard.index + 1) * b].to(images.device)
        partners = (all_gather_rows(images, shard)[idx], all_gather_rows(targets, shard)[idx])
    if draw.cutmix:
        return cutmix_batch(images, targets, draw.lam, draw.perm, draw.cy, draw.cx, partners)
    return mixup_batch(images, targets, draw.lam, draw.perm, partners)


def mixup_cutmix(generator: torch.Generator, images: torch.Tensor, targets: torch.Tensor,
                 mixup_alpha: float = 0.0, cutmix_alpha: float = 0.0,
                 switch_prob: float = 0.5):
    """Draw one step's mix from ``generator`` and apply it (the JAX package's
    ``mixup_cutmix``); with both alphas 0 the batch passes through and nothing
    is drawn."""
    b, _, h, w = images.shape
    draw = draw_mix(generator, b, h, w, mixup_alpha, cutmix_alpha, switch_prob)
    return apply_mix(draw, images, targets)

"""Segmentation loss (port of ``convnet_approximater_tpu/segmentation/losses.py``).

Per-pixel cross-entropy with mmseg's conventions: logits at 1/8 resolution are
bilinearly upsampled to the labels inside the loss, and ``ignore_index``
pixels add nothing to the loss or its gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ham_head import upsample_logits


def seg_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = 255,
                      class_weights=None) -> torch.Tensor:
    """Mean per-pixel CE of NCHW ``logits`` (B, K, h, w) against ``labels``
    (B, H, W): the logits are upsampled when (h, w) != (H, W); each pixel
    weighs 1 (``class_weights[label]`` when given), an ignored one 0; the sum
    is divided by ``max(sum of weights, 1)``, so a batch with every pixel
    ignored gives 0 (``F.cross_entropy``'s mean would give NaN)."""
    if tuple(logits.shape[2:]) != tuple(labels.shape[1:]):
        logits = upsample_logits(logits, labels.shape[1:])
    logp = F.log_softmax(logits.float(), dim=1)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    ll = logp.gather(1, safe[:, None])[:, 0]
    w = valid.float()
    if class_weights is not None:
        w = w * torch.as_tensor(class_weights, dtype=torch.float32, device=logits.device)[safe]
    return -(ll * w).sum() / w.sum().clamp_min(1.0)

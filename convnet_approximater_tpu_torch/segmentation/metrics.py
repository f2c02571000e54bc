"""Segmentation metrics: a streaming confusion matrix, then mIoU and aAcc (port
of ``convnet_approximater_tpu/segmentation/metrics.py``).

:func:`confusion_matrix` counts on the tensors' device with one ``index_add_``
(no host sync); :func:`iou_from_confusion` is the JAX package's host-side
reduction, copied: mmseg's ``mean_iou``, per-class IoU tp / (tp + fp + fn), the
mean over the classes that appear, aAcc the trace over the total.
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor, num_classes: int,
                     ignore_index: int = 255) -> torch.Tensor:
    """(K, K) int64 counts, rows the true class, columns the predicted one, of
    integer ``pred``/``label`` of one shape; pixels labelled ``ignore_index``
    are dropped.  The JAX package sums float32 weights, exact up to 2**24
    pixels per cell; int64 counts agree with it below that and stay exact above."""
    K = num_classes
    label = label.reshape(-1).long()
    valid = label != ignore_index
    p = pred.reshape(-1).long().clamp(0, K - 1)
    idx = torch.where(valid, label * K + p, torch.full_like(label, K * K))  # K*K: dropped
    counts = torch.zeros(K * K + 1, dtype=torch.int64, device=label.device)
    counts.index_add_(0, idx, torch.ones_like(idx))
    return counts[:K * K].reshape(K, K)


def iou_from_confusion(cm) -> dict:
    """Host-side reduction of an accumulated confusion matrix."""
    cm = np.asarray(cm, np.float64)
    tp = np.diag(cm)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    denom = tp + fp + fn
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(denom > 0, tp / np.maximum(denom, 1e-12), np.nan)
        acc = np.where(cm.sum(axis=1) > 0,
                       tp / np.maximum(cm.sum(axis=1), 1e-12), np.nan)
    present = ~np.isnan(iou)
    total = cm.sum()
    return dict(
        iou=iou,
        miou=float(np.nanmean(iou)) if present.any() else 0.0,
        macc=float(np.nanmean(acc)) if present.any() else 0.0,
        aacc=float(tp.sum() / total) if total > 0 else 0.0,
    )

"""Segmentation fine-tune hook: L2 feature reconstruction and per-pixel CE (port
of ``convnet_approximater_tpu/segmentation/finetune.py``).

``SegL2Reconstruct`` is ``L2Reconstruct`` with the task's plug points swapped:
the loss is :func:`~.losses.seg_cross_entropy` (resize-in-loss,
``ignore_index``), validation streams a confusion matrix into loss, mIoU and
aAcc (``eval_metric`` defaults to ``miou``), and the default data is
:class:`~.data.SyntheticSeg`.  Everything else (teachers, the masked
optimizer, checkpoints, resume) is the parent's.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.distributed as dist

from convnet_approximater_tpu_torch.classification import AverageMeter
from convnet_approximater_tpu_torch.hooks.finetune import L2Reconstruct
from convnet_approximater_tpu_torch.hooks.hook import HOOK
from convnet_approximater_tpu_torch.parallel.data_parallel import sum_over
from convnet_approximater_tpu_torch.utils import get_logger

from .data import SyntheticSeg
from .ham_head import upsample_logits
from .losses import seg_cross_entropy
from .metrics import confusion_matrix, iou_from_confusion


@HOOK.register_module()
class SegL2Reconstruct(L2Reconstruct):
    def __init__(self, runner, priority, ignore_index: int = 255, **kwargs):
        other = dict(kwargs.get("other_args") or {})
        other.setdefault("eval_metric", "miou")
        kwargs["other_args"] = other
        super().__init__(runner, priority, **kwargs)
        self.ignore_index = ignore_index

    def _ce_fn(self) -> Callable:
        ignore = self.ignore_index
        return lambda logits, labels: seg_cross_entropy(logits, labels, ignore_index=ignore)

    def _default_datasets(self, image_size, num_classes):
        return (SyntheticSeg(128, image_size, num_classes, split="train"),
                SyntheticSeg(64, image_size, num_classes, split="validation"))

    @torch.no_grad()
    def _validate(self, loader) -> Dict[str, float]:
        """Loss, mIoU and aAcc of the eval forward over the validation batches,
        from one confusion matrix summed on the device (and across processes
        over the data axis, as each batch's loss)."""
        model = self.runner.model
        num_classes = self.other_args.num_classes
        losses_m = AverageMeter()
        cm_total = None
        max_batches = self.other_args.max_eval_batches
        model.eval()
        for i, (images, labels) in enumerate(loader):
            if max_batches and i >= max_batches:
                break
            logits = model(images).float()
            loss = seg_cross_entropy(logits, labels, ignore_index=self.ignore_index)
            pred = upsample_logits(logits, labels.shape[1:]).argmax(dim=1)
            cm = confusion_matrix(pred, labels, num_classes, self.ignore_index)
            bs = images.shape[0]
            if self.shard is not None:
                loss, bs = sum_over([float(loss) * bs, bs], self.shard, images.device)
                loss, bs = loss / bs, int(bs)
            losses_m.update(float(loss), bs)
            cm_total = cm if cm_total is None else cm_total + cm
        if cm_total is not None and self.shard is not None:
            dist.all_reduce(cm_total, group=self.shard.group)
        stats = iou_from_confusion(cm_total.cpu().numpy()) if cm_total is not None else {}
        metrics = dict(loss=losses_m.avg, miou=stats.get("miou", 0.0),
                       aacc=stats.get("aacc", 0.0))
        get_logger().info(f"Eval: loss {metrics['loss']:.4f}  mIoU {metrics['miou']:.4f}  "
                          f"aAcc {metrics['aacc']:.4f}")
        return metrics

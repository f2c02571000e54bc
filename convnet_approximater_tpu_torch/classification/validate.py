"""Classification validation (port of
``convnet_approximater_tpu/classification/validate.py``).

:class:`ValidateHelper` evaluates a runner's model (read at validate time) or
a given model: loss and top-1/top-5 over a loader, with the model in
``eval()`` under ``torch.no_grad()``, so the kernel layers take their kernels.
The images enter in the model's serving type (``utils.dtype.serving_dtype``:
a bf16 surface reads bf16); ``amp=True`` evaluates a bf16 copy of the model
(``cast_floating``: the parameters, not the running statistics) on bf16
images, the logits reduced in float32, as the JAX helper's autocast eval does.
"""

from __future__ import annotations

import copy
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from convnet_approximater_tpu_torch.data import (IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD,
                                                 Loader, Synthetic, build_dataset)
from convnet_approximater_tpu_torch.utils.config import Config
from convnet_approximater_tpu_torch.utils.dtype import cast_floating, serving_dtype
from convnet_approximater_tpu_torch.utils.logger import get_logger

_default_eval_cfg = dict(
    batch_size=128,
    log_freq=50,
    input_size=(224, 224, 3),
    num_classes=1000,
    mean=IMAGENET_DEFAULT_MEAN,
    std=IMAGENET_DEFAULT_STD,
    dataset=None,  # DATASET registry cfg; None -> synthetic smoke data
    split="validation",
    num_batches=None,  # cap for smoke runs
    use_mesh=False,
    amp=False,
    valid_labels=None,  # path to a txt of valid class indices (subset eval)
    real_labels=None,  # path to npz/json of per-sample label sets: real_top1/real_top5
    test_input_size=None,  # (H, W): eval at another resolution
)

AMP_TODO = "bf16 training is ROADMAP.md queue 1 item 7 (its training half)"
MESH_TODO = "more than one device is ROADMAP.md queue 1 item 12"


class AverageMeter:
    def __init__(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)


def top_indices(logits: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` classes of highest logit per row, in the order of a stable
    descending sort (the JAX package's ``argsort(-logits)``, ties included)."""
    return torch.argsort(-logits, dim=-1, stable=True)[:, :k]


def accuracy_sums(logits: torch.Tensor, labels: torch.Tensor, topk=(1, 5)):
    """Per-batch correct counts for each k."""
    correct = top_indices(logits, max(topk)) == labels[:, None]
    return [correct[:, :k].any(dim=1).sum() for k in topk]


class RealLabelsSets:
    """ImageNet "Real labels" re-assessment: each validation sample carries a
    set of acceptable labels, and a prediction is correct when it hits any of
    them.  Samples with an empty set are skipped.

    Reads a .json file (a list of label lists in the dataset's order, or a
    dict keyed by file name, taken in sorted order) or an .npz with a
    ``labels`` (N, K) int array padded with -1.
    """

    def __init__(self, path: str, topk=(1, 5)):
        import json

        if path.endswith(".npz"):
            with np.load(path) as d:
                arr = d["labels"]
            self.sets = [set(int(v) for v in row if v >= 0) for row in arr]
        else:
            with open(path) as f:
                data = json.load(f)
            if isinstance(data, dict):
                data = [data[k] for k in sorted(data)]
            self.sets = [set(int(v) for v in row) for row in data]
        self.topk = topk
        self.correct = {k: 0 for k in topk}
        self.counted = 0

    def add(self, top: np.ndarray, start: int):
        """``top`` (B, maxk) predictions for samples [start, start + B)."""
        for i, row in enumerate(np.asarray(top)):
            idx = start + i
            if idx >= len(self.sets) or not self.sets[idx]:
                continue
            self.counted += 1
            for k in self.topk:
                if any(int(p) in self.sets[idx] for p in row[:k]):
                    self.correct[k] += 1

    def accuracy(self, k: int) -> float:
        return 100.0 * self.correct[k] / max(self.counted, 1)


@torch.no_grad()
def eval_batch(model, images, labels, valid_mask: Optional[torch.Tensor] = None):
    """``(loss, top-1 count, top-5 count, top-5 indices)`` of one batch, the
    model in ``eval()`` under ``torch.no_grad()``."""
    logits = model(images).float()
    if valid_mask is not None:
        logits = logits.masked_fill(~valid_mask[None, :], float("-inf"))
    loss = F.cross_entropy(logits, labels)
    c1, c5 = accuracy_sums(logits, labels)
    return loss, c1, c5, top_indices(logits, 5)


class ValidateHelper:
    def __init__(self, runner_or_model, eval_cfg, device=None):
        self.cfg = Config()
        self.cfg.update(_default_eval_cfg)
        self.cfg.update(eval_cfg or {})
        # a runner (its model is read at validate time) or a model
        self._runner = None
        if hasattr(runner_or_model, "model") and hasattr(runner_or_model, "device"):
            self._runner = runner_or_model
        else:
            self._model = runner_or_model
            self._device = torch.device(device if device is not None else "cuda")

    def _resolve(self):
        if self._runner is not None:
            return self._runner.model, self._runner.device
        return self._model, self._device

    def _make_loader(self, device):
        size = tuple(self.cfg.test_input_size or self.cfg.input_size[:2])
        if self.cfg.dataset:
            ds = build_dataset(dict(self.cfg.dataset), split=self.cfg.split)
        else:
            ds = Synthetic(num_samples=self.cfg.batch_size * 4, image_size=size + (3,),
                           num_classes=self.cfg.num_classes, split="validation")
        return Loader(ds, self.cfg.batch_size, shuffle=False, drop_last=True,
                      mean=self.cfg.mean, std=self.cfg.std, image_size=size, device=device)

    def validate(self) -> dict:
        logger = get_logger()
        model, device = self._resolve()
        if self.cfg.use_mesh and device.type == "cuda" and torch.cuda.device_count() > 1:
            raise NotImplementedError(f"ValidateHelper use_mesh: {MESH_TODO}")
        valid_mask = None
        if self.cfg.valid_labels:
            with open(self.cfg.valid_labels) as f:
                valid = {int(line.strip()) for line in f if line.strip()}
            valid_mask = torch.tensor([i in valid for i in range(self.cfg.num_classes)],
                                      device=device)
            logger.info(f"subset eval over {len(valid)} valid classes")
        real = RealLabelsSets(self.cfg.real_labels) if self.cfg.real_labels else None

        loader = self._make_loader(device)
        loss_m, top1_m, top5_m, time_m = (AverageMeter() for _ in range(4))
        n_batches = len(loader)
        if self.cfg.num_batches:
            n_batches = min(n_batches, self.cfg.num_batches)
        was_training = model.training
        model.eval()
        served, dtype = model, serving_dtype(model)
        if self.cfg.amp:  # autocast eval: bf16 compute over the float32 weights
            served, dtype = cast_floating(copy.deepcopy(model), torch.bfloat16), torch.bfloat16
        cursor = 0
        end = time.time()
        try:
            for i, (images, labels) in enumerate(loader):
                if i >= n_batches:
                    break
                loss, c1, c5, top5 = eval_batch(served, images.to(dtype), labels, valid_mask)
                bs = images.shape[0]
                if real is not None:
                    real.add(top5.cpu().numpy(), cursor)
                cursor += bs
                loss_m.update(float(loss), bs)
                top1_m.update(float(c1) / bs * 100.0, bs)
                top5_m.update(float(c5) / bs * 100.0, bs)
                time_m.update(time.time() - end)
                end = time.time()
                if i % self.cfg.log_freq == 0 or i == n_batches - 1:
                    logger.info(
                        f"Test: [{i:>4d}/{n_batches}]  "
                        f"Time: {time_m.val:.3f} ({time_m.avg:.3f})  "
                        f"Loss: {loss_m.val:>7.4f} ({loss_m.avg:>6.4f})  "
                        f"Acc@1: {top1_m.val:>7.4f} ({top1_m.avg:>7.4f})  "
                        f"Acc@5: {top5_m.val:>7.4f} ({top5_m.avg:>7.4f})")
        finally:
            model.train(was_training)
        out = dict(loss=loss_m.avg, top1=top1_m.avg, top5=top5_m.avg,
                   param_count=sum(p.numel() for p in model.parameters()),
                   img_size=(self.cfg.test_input_size or self.cfg.input_size)[0])
        if real is not None:
            out["real_top1"] = real.accuracy(1)
            out["real_top5"] = real.accuracy(5)
            logger.info(f"Real labels: Acc@1 {out['real_top1']:.4f} "
                        f"Acc@5 {out['real_top5']:.4f} ({real.counted} labeled samples)")
        return out

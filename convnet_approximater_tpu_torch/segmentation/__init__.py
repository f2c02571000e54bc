"""SegNeXt segmentation (port of ``convnet_approximater_tpu/segmentation/``).

``SegNeXt`` (``MODEL``) and ``SyntheticSeg`` (``DATASET``) register when the
models package imports this one; ``SegL2Reconstruct`` (``HOOK``) lives in
:mod:`.finetune`, which the hooks package imports, since the fine-tune builds
on the hooks and the hooks on the models.
"""

from .data import SyntheticSeg
from .ham_head import Hamburger, LightHamHead, nmf2d, nmf_draw, resize_bilinear, upsample_logits
from .losses import seg_cross_entropy
from .metrics import confusion_matrix, iou_from_confusion
from .segnext import SegNeXt

__all__ = ["SegNeXt", "LightHamHead", "Hamburger", "nmf2d", "nmf_draw", "resize_bilinear",
           "upsample_logits", "seg_cross_entropy", "confusion_matrix", "iou_from_confusion",
           "SyntheticSeg"]

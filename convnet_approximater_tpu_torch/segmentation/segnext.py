"""SegNeXt segmentation model: the MSCAN backbone and the Light-Ham decode head
(port of ``convnet_approximater_tpu/segmentation/segnext.py``).

The backbone is the port's switchable ``MSCAN``, so ``register_switchable(MSCA,
...)``, MscaRep and the serving passes apply unchanged, and an eval forward of
each MSCA block runs ``msca_fused`` on the card.  The JAX model's
``scan_blocks`` and ``remat`` are not taken: the port's MSCAN runs its stages
as plain loops and no SegNeXt config sets them.
"""

from __future__ import annotations

from convnet_approximater_tpu_torch.models.mscan import MSCAN
from convnet_approximater_tpu_torch.models.switchable import MODEL, SwitchableModel
from convnet_approximater_tpu_torch.parallel.spatial import global_size

from .ham_head import LightHamHead, upsample_logits


@MODEL.register_module()
class SegNeXt(SwitchableModel):
    """SegNeXt-T/S by ``num_channels``/``num_blocks`` (MSCAN-t defaults).  Takes
    NCHW images, best in ``torch.channels_last``; returns NCHW logits at 1/8 of
    the input resolution, or at the input's with ``full_res``."""

    def __init__(self, in_channels: int = 3, num_channels=(32, 64, 160, 256),
                 num_blocks=(3, 3, 5, 2), exp_ratios=(8, 8, 4, 4), drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, num_classes: int = 150, ham_channels: int = 256,
                 ham_rank: int = 64, ham_iters: int = 6, in_indices=(1, 2, 3), init_cfg=None,
                 full_res: bool = False):
        super().__init__(init_cfg=init_cfg)
        self.num_classes = num_classes
        self.in_indices = tuple(in_indices)
        self.full_res = full_res
        self.backbone = MSCAN(in_channels=in_channels, num_channels=num_channels,
                              num_blocks=num_blocks, exp_ratios=exp_ratios,
                              drop_rate=drop_rate, drop_path_rate=drop_path_rate)
        self.decode_head = LightHamHead(in_channels=[num_channels[i] for i in self.in_indices],
                                        num_classes=num_classes, ham_channels=ham_channels,
                                        rank=ham_rank, iters=ham_iters)

    def trunk_groups(self):
        """``deploy.prune_trunks`` groups: the backbone's, with the squeeze conv
        consuming each tapped stage as one segment of its concatenated input,
        offset by the widths of the earlier tapped stages' LayerNorms (groups
        are sliced in stage order, so those widths are final by then)."""
        groups = self.backbone.trunk_groups(prefix="backbone.")
        names = [n for n, _ in self.backbone.layers.named_children()]
        for pos, i in enumerate(self.in_indices):
            groups[i]["consumers"].append(dict(
                path="decode_head.squeeze",
                offset_modules=[f"backbone.layers.{names[j]}.2" for j in self.in_indices[:pos]]))
        return groups

    def forward(self, x):
        feats = self.backbone(x)
        logits = self.decode_head([feats[i] for i in self.in_indices])
        if self.full_res:
            logits = upsample_logits(logits, global_size(x))
        return logits

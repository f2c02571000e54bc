"""MSCAN (SegNeXt) backbone and classifier (port of
``convnet_approximater_tpu/models/mscan.py``).

4 stages of (StemConv/DownSample -> MultiScaleConvAttnModule x n -> LayerNorm);
a block is BN -> SpatialAttention(proj -> GELU -> MSCA -> proj + shortcut) ->
BN -> conv-FFN, with per-block layer scale and drop path; the classifier adds
global average pooling and a Linear head.  Stages run as plain loops, or as
GPipe pipelines across processes after ``MSCAN.enable_pipeline``
(``models/stage_exec.py``); ``MSCAN_Classifier.pipeline_units`` is the whole
model's decomposition for ``parallel.build_model_pipeline``.  Parameter names
equal the JAX package's param paths.
"""

from __future__ import annotations

import torch
from torch import nn

from convnet_approximater_tpu_torch.layers import MSCA, DropPath
from convnet_approximater_tpu_torch.nn import BatchNorm2d, Conv2d, Dropout, GELU, LayerNorm, Linear, gelu
from convnet_approximater_tpu_torch.parallel.pp_model import Tail, Unit, unit_from_module
from convnet_approximater_tpu_torch.parallel.spatial import global_mean

from .stage_exec import BlockStageExec
from .switchable import MODEL, SwitchableModel


class StemConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.proj = nn.Sequential(
            Conv2d(in_channels, out_channels // 2, 3, stride=2, padding=1),
            BatchNorm2d(out_channels // 2),
            GELU(),
            Conv2d(out_channels // 2, out_channels, 3, stride=2, padding=1),
            BatchNorm2d(out_channels),
        )

    def forward(self, x):
        return self.proj(x)


class FFN(nn.Module):
    """1x1 conv -> depthwise 3x3 -> GELU -> 1x1 conv -> dropout."""

    # the Megatron pair of tensor parallelism (parallel/tp.py): fc1's sharded
    # hidden channels pass dconv and reach fc2 sharded
    TP_CHAINS = (("fc1", "dconv", "fc2"),)

    def __init__(self, num_channel: int, hidden_channel: int, drop: float):
        super().__init__()
        self.num_channel = num_channel
        self.hidden_channel = hidden_channel
        self.drop_rate = drop
        self.fc1 = Conv2d(num_channel, hidden_channel, 1)
        self.dconv = Conv2d(hidden_channel, hidden_channel, 3, padding=1, groups=hidden_channel)
        self.fc2 = Conv2d(hidden_channel, num_channel, 1)
        self.drop = Dropout(drop)

    def forward(self, x):
        return self.drop(self.fc2(gelu(self.dconv(self.fc1(x)))))


class SpatialAttention(nn.Module):
    """``inner_channel`` (default ``num_channel``) is the width of the gated
    MSCA branch between the two projections, the axis ``AttnPrune`` shrinks."""

    def __init__(self, num_channel: int, k1_size: int = 5, k_sizes=(7, 11, 21),
                 inner_channel: int = None):
        super().__init__()
        self.num_channel = num_channel
        self.inner_channel = inner_channel or num_channel
        inner = self.inner_channel
        self.proj_1 = Conv2d(num_channel, inner, 1)
        self.spatial_gating_unit = MSCA(inner, k1_size, k_sizes)
        self.proj_2 = Conv2d(inner, num_channel, 1)

    def forward(self, x):
        y = self.proj_2(self.spatial_gating_unit(gelu(self.proj_1(x))))
        return y + x


class MultiScaleConvAttnModule(nn.Module):
    """One MSCAN block."""

    LAYER_SCALE_INIT = 1e-2

    def __init__(self, num_channel: int, hidden_channel: int, drop: float, drop_path: float):
        super().__init__()
        self.num_channel = num_channel
        self.norm1 = BatchNorm2d(num_channel)
        self.attn = SpatialAttention(num_channel)
        self.norm2 = BatchNorm2d(num_channel)
        self.mlp = FFN(num_channel, hidden_channel, drop)
        self.drop_path = DropPath(drop_path)
        self.layer_scale_1 = nn.Parameter(self.LAYER_SCALE_INIT * torch.ones(num_channel))
        self.layer_scale_2 = nn.Parameter(self.LAYER_SCALE_INIT * torch.ones(num_channel))

    def forward(self, x):
        x = x + self.drop_path(self.layer_scale_1[:, None, None] * self.attn(self.norm1(x)))
        x = x + self.drop_path(self.layer_scale_2[:, None, None] * self.mlp(self.norm2(x)))
        return x


class DownSample(nn.Module):
    def __init__(self, in_channel: int, out_channel: int):
        super().__init__()
        self.proj = Conv2d(in_channel, out_channel, 3, stride=2, padding=1)
        self.norm = BatchNorm2d(out_channel)

    def forward(self, x):
        return self.norm(self.proj(x))


class MSCAN(BlockStageExec, nn.Module):
    """The backbone: returns the feature map of every stage."""

    def __init__(self, in_channels: int = 3, num_channels=(32, 64, 160, 256),
                 num_blocks=(3, 3, 5, 2), exp_ratios=(8, 8, 4, 4), drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0):
        super().__init__()
        if not len(num_channels) == len(num_blocks) == len(exp_ratios):
            raise ValueError("num_channels, num_blocks and exp_ratios need one entry per stage")
        self.num_channels = tuple(num_channels)
        self.num_blocks = tuple(num_blocks)
        total = sum(num_blocks)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        self.layers = nn.ModuleList()
        cur = 0
        for i, nb in enumerate(num_blocks):
            out_c = num_channels[i]
            down = (StemConv(in_channels, out_c) if i == 0
                    else DownSample(num_channels[i - 1], out_c))
            stage = nn.Sequential(*[
                MultiScaleConvAttnModule(out_c, out_c * exp_ratios[i], drop_rate, dpr[cur + j])
                for j in range(nb)
            ])
            self.layers.append(nn.ModuleList([down, stage, LayerNorm(out_c)]))
            cur += nb

    def trunk_groups(self, prefix: str = ""):
        """Residual-trunk channel groups of ``deploy.prune_trunks``, one per
        stage: the stem's or downsample's last conv (and its BN) and every
        block's ``attn.proj_2`` and ``mlp.fc2`` produce the trunk; every
        block's ``attn.proj_1`` and ``mlp.fc1`` and the next stage's
        downsample consume it; the block BNs, the stage LayerNorm and the
        layer-scale vectors slice along.  Paths are dense module names: run
        the pass before any substitution."""
        groups = []
        names = [n for n, _ in self.layers.named_children()]
        for i, (name, layer) in enumerate(self.layers.named_children()):
            base = f"{prefix}layers.{name}"
            producers = ([(f"{base}.0.proj.3", f"{base}.0.proj.4")] if i == 0
                         else [(f"{base}.0.proj", f"{base}.0.norm")])
            consumers, norms, vectors, attrs = [], [], [], []
            for bname, _ in layer[1].named_children():
                bb = f"{base}.1.{bname}"
                consumers += [f"{bb}.attn.proj_1", f"{bb}.mlp.fc1"]
                producers += [(f"{bb}.attn.proj_2", None), (f"{bb}.mlp.fc2", None)]
                norms += [f"{bb}.norm1", f"{bb}.norm2"]
                vectors += [f"{bb}.layer_scale_1", f"{bb}.layer_scale_2"]
                # the widths the prune and rep apps build their targets from
                attrs += [(bb, "num_channel"), (f"{bb}.attn", "num_channel"),
                          (f"{bb}.mlp", "num_channel")]
            norms.append(f"{base}.2")  # the stage LayerNorm
            groups.append(dict(producers=producers, consumers=consumers, norms=norms,
                               vectors=vectors, attrs=attrs))
        for i in range(len(groups) - 1):
            groups[i]["consumers"].append(f"{prefix}layers.{names[i + 1]}.0.proj")
        return groups

    def pipeline_stages(self):
        return [layer[1] for layer in self.layers]

    def forward(self, x):
        features = []
        for s, (down, stage, norm) in enumerate(self.layers):
            x = norm(self._exec_stage(s, stage, down(x)))
            features.append(x)
        return features


@MODEL.register_module()
class MSCAN_Classifier(SwitchableModel):
    """MSCAN + global average pool + Linear head.  Takes NCHW images, best in
    ``torch.channels_last``."""

    def __init__(self, in_channels: int = 3, num_channels=(32, 64, 160, 256),
                 num_blocks=(3, 3, 5, 2), exp_ratios=(8, 8, 4, 4), drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, num_classes: int = 1000, init_cfg=None):
        super().__init__(init_cfg=init_cfg)
        self.num_classes = num_classes
        self.backbone = MSCAN(in_channels=in_channels, num_channels=num_channels,
                              num_blocks=num_blocks, exp_ratios=exp_ratios,
                              drop_rate=drop_rate, drop_path_rate=drop_path_rate)
        self.head = Linear(num_channels[-1], num_classes, bias=True)

    def trunk_groups(self):
        """The backbone's trunk groups, with the head consuming the last."""
        groups = self.backbone.trunk_groups(prefix="backbone.")
        groups[-1]["consumers"].append("head")
        return groups

    def pipeline_units(self):
        """The whole model as ordered units for ``parallel.build_model_pipeline``:
        every stem or downsample, every block (substituted or not), every stage
        norm, and the pooling with the head; run in order they are the eval forward."""
        units = []
        for lname, layer in self.backbone.layers.named_children():
            base = f"backbone.layers.{lname}"
            units.append(unit_from_module(f"{base}.0", layer[0]))
            units += [unit_from_module(f"{base}.1.{bname}", block)
                      for bname, block in layer[1].named_children()]
            units.append(unit_from_module(f"{base}.2", layer[2]))
        units.append(Unit("head", Tail(self.head)))
        return units

    def forward(self, x):
        x = self.backbone(x)[-1]
        return self.head(global_mean(x))

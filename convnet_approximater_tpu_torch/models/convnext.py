"""ConvNeXt (port of ``convnet_approximater_tpu/models/convnext.py``).

A block is dwconv 7x7 -> LayerNorm -> Linear (4x) -> GELU -> Linear ->
``gamma`` layer scale -> drop path + residual.  The model runs in
``torch.channels_last``: the block's dwconv (or the strip cascades DwSepRep
made of it) takes the NCHW view, and ``permute(0, 2, 3, 1)`` of its output is
then a contiguous NHWC tensor for the norm, the two Linears and ``gamma``,
as the JAX package runs them.  Parameter names equal the JAX param paths
(``downsample_layers.{0..3}.{0,1}``, ``stages.{s}.{i}.dwconv/norm/pwconv1/
pwconv2/gamma.gamma``, ``norm``, ``head``), so ``convert.params_from_jax``
carries the weights across.
"""

from __future__ import annotations

import torch
from torch import nn

from convnet_approximater_tpu_torch.layers import DropPath
from convnet_approximater_tpu_torch.nn import GELU, Conv2d, LayerNorm, Linear
from convnet_approximater_tpu_torch.parallel.pp_model import Tail, Unit, subtree, unit_from_module
from convnet_approximater_tpu_torch.parallel.spatial import global_mean

from .stage_exec import BlockStageExec
from .switchable import MODEL, SwitchableModel

EPS = 1e-6  # the official ConvNeXt LayerNorms' eps


class LayerScale(nn.Module):
    """Per-channel learnable scale (the block's ``gamma``) on the last axis."""

    def __init__(self, dim: int, init_value: float = 1e-6):
        super().__init__()
        self.init_value = init_value
        self.gamma = nn.Parameter(torch.full((dim,), float(init_value)))

    def forward(self, x):
        return x * self.gamma


class ConvNeXtBlock(nn.Module):
    """``hidden`` overrides the MLP's 4x expansion: the width ``MlpPrune`` shrinks."""

    TP_CHAINS = (("pwconv1", "act", "pwconv2"),)  # the tensor-parallel pair (parallel/tp.py)

    def __init__(self, dim: int, drop_path: float = 0.0, layer_scale: float = 1e-6,
                 hidden: int = None):
        super().__init__()
        self.dim = dim
        self.hidden = 4 * dim if hidden is None else hidden
        self.dwconv = Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=EPS)
        self.pwconv1 = Linear(dim, self.hidden)
        self.act = GELU()
        self.pwconv2 = Linear(self.hidden, dim)
        self.gamma = LayerScale(dim, layer_scale)
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        y = self.dwconv(x).permute(0, 2, 3, 1)  # NHWC, contiguous when x is channels_last
        y = self.gamma(self.pwconv2(self.act(self.pwconv1(self.norm(y)))))
        return x + self.drop_path(y.permute(0, 3, 1, 2))


_ARCHS = {
    "tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
}


@MODEL.register_module()
class ConvNeXt(BlockStageExec, SwitchableModel):
    """Takes NCHW images, best in ``torch.channels_last``.  Its stages run as
    GPipe pipelines across processes after ``enable_pipeline``
    (``models/stage_exec.py``)."""

    def __init__(self, arch: str = "tiny", num_classes: int = 1000,
                 drop_path_rate: float = 0.0, layer_scale: float = 1e-6,
                 depths=None, dims=None, init_cfg=None):
        super().__init__(init_cfg=init_cfg)
        if depths is None or dims is None:
            depths, dims = _ARCHS[arch]
        self.depths, self.dims = tuple(depths), tuple(dims)
        downs = [nn.Sequential(Conv2d(3, dims[0], 4, stride=4), LayerNorm(dims[0], eps=EPS))]
        for i in range(3):
            downs.append(nn.Sequential(LayerNorm(dims[i], eps=EPS),
                                       Conv2d(dims[i], dims[i + 1], 2, stride=2)))
        self.downsample_layers = nn.ModuleList(downs)
        total = sum(depths)
        rates = [drop_path_rate * j / max(total - 1, 1) for j in range(total)]
        stages, k = [], 0
        for i in range(4):
            stages.append(nn.Sequential(*[ConvNeXtBlock(dims[i], rates[k + j], layer_scale)
                                          for j in range(depths[i])]))
            k += depths[i]
        self.stages = nn.ModuleList(stages)
        self.norm = nn.LayerNorm(dims[-1], eps=EPS)
        self.head = Linear(dims[-1], num_classes)

    def trunk_groups(self):
        """``deploy.prune_trunks`` groups, one per stage: the downsample conv and
        every block's ``pwconv2`` produce the trunk; every block's ``pwconv1``
        and the next downsample conv (or the head) consume it; the block
        dwconvs ride the mask as depthwise pass-throughs, and the LayerNorms
        and ``gamma`` vectors slice along."""
        groups = []
        for i in range(4):
            if i == 0:
                producers, norms = [("downsample_layers.0.0", None)], ["downsample_layers.0.1"]
            else:
                producers, norms = [(f"downsample_layers.{i}.1", None)], []
            consumers, vectors, depthwise, attrs = [], [], [], []
            for bname, _ in self.stages[i].named_children():
                bb = f"stages.{i}.{bname}"
                depthwise.append(f"{bb}.dwconv")
                consumers.append(f"{bb}.pwconv1")
                producers.append((f"{bb}.pwconv2", None))
                norms.append(f"{bb}.norm")
                vectors.append(f"{bb}.gamma.gamma")
                attrs.append((bb, "dim"))  # MlpPrune builds its target from dim
            if i < 3:
                norms.append(f"downsample_layers.{i + 1}.0")
                consumers.append(f"downsample_layers.{i + 1}.1")
            else:
                norms.append("norm")
                consumers.append("head")
            groups.append(dict(producers=producers, consumers=consumers, norms=norms,
                               vectors=vectors, depthwise=depthwise, attrs=attrs))
        return groups

    def pipeline_stages(self):
        return list(self.stages)

    def pipeline_units(self):
        """The whole model as ordered units for ``parallel.build_model_pipeline``:
        each downsample layer, each block (substituted or not), and the pooling
        with the norm and the head."""
        units = []
        for i in range(4):
            units.append(unit_from_module(f"downsample_layers.{i}",
                                          subtree(self, "downsample_layers", i)))
            units += [unit_from_module(f"stages.{i}.{bname}", block)
                      for bname, block in self.stages[i].named_children()]
        units.append(Unit("norm+head", Tail(self.norm, self.head)))
        return units

    def forward(self, x):
        for s, (down, stage) in enumerate(zip(self.downsample_layers, self.stages)):
            x = self._exec_stage(s, stage, down(x))
        return self.head(self.norm(global_mean(x)))


@MODEL.register_module()
class ConvNeXtTiny(ConvNeXt):
    def __init__(self, num_classes: int = 1000, drop_path_rate: float = 0.0, init_cfg=None):
        super().__init__("tiny", num_classes, drop_path_rate, init_cfg=init_cfg)

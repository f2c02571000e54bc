"""ResNet-18/34/50/101/152 (port of ``convnet_approximater_tpu/models/resnet.py``).

Names follow torchvision (``conv1``, ``bn1``, ``layer{1..4}.{i}.conv{j}``,
``downsample.0/1``, ``fc``), as in the JAX package, so its checkpoints carry
across with :func:`~convnet_approximater_tpu_torch.convert.params_from_jax`.
Each block declares its children in the JAX order (``conv1, bn1, relu, conv2,
bn2, [conv3, bn3,] downsample``): ``register_switchable`` walks them in that
order, and a config's ``IndicesFilter`` counts positions in that walk.
``Bottleneck`` strides its 3x3 (ResNet v1.5).  ``ResNet.pipeline_units`` is
the whole model's decomposition for ``parallel.build_model_pipeline``.
"""

from __future__ import annotations

from torch import nn

from convnet_approximater_tpu_torch.nn import (AdaptiveAvgPool2d, BatchNorm2d, Conv2d, Linear,
                                               MaxPool2d, ReLU)
from convnet_approximater_tpu_torch.parallel.pp_model import Unit, subtree, unit_from_module

from .switchable import MODEL, SwitchableModel


def _downsample(in_c: int, out_c: int, stride: int):
    if stride == 1 and in_c == out_c:
        return None
    return nn.Sequential(Conv2d(in_c, out_c, 1, stride=stride, bias=False), BatchNorm2d(out_c))


class BasicBlock(nn.Module):
    """Two 3x3 convs and the identity (torchvision's ``BasicBlock``)."""

    expansion = 1
    TP_CHAINS = (("conv1", "bn1", "conv2"),)  # the tensor-parallel pair (parallel/tp.py)

    def __init__(self, in_c: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_c, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.relu = ReLU()
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = _downsample(in_c, planes * self.expansion, stride)

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(y + identity)


class Bottleneck(nn.Module):
    """1x1 reduce, 3x3 (strided), 1x1 expand (torchvision's ``Bottleneck``)."""

    expansion = 4
    TP_CHAINS = (("conv1", "bn1", "conv2"),)

    def __init__(self, in_c: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_c, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * self.expansion, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * self.expansion)
        self.relu = ReLU()
        self.downsample = _downsample(in_c, planes * self.expansion, stride)

    def forward(self, x):
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return self.relu(y + identity)


_DEPTHS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


@MODEL.register_module()
class ResNet(SwitchableModel):
    def __init__(self, depth: int = 18, num_classes: int = 1000, init_cfg=None):
        super().__init__(init_cfg=init_cfg)
        block, counts = _DEPTHS[depth]
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        self.relu = ReLU()
        self.maxpool = MaxPool2d(kernel_size=3, stride=2, padding=1)
        in_c = 64
        for i, (planes, n) in enumerate(zip((64, 128, 256, 512), counts)):
            blocks = []
            for j in range(n):
                blocks.append(block(in_c, planes, stride=2 if (i > 0 and j == 0) else 1))
                in_c = planes * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.avgpool = AdaptiveAvgPool2d((1, 1))
        self.fc = Linear(512 * block.expansion, num_classes)

    def pipeline_units(self):
        """The whole model as ordered units for ``parallel.build_model_pipeline``:
        the conv1, bn1, relu and maxpool stem, every residual block (substituted
        or not), and the pooling with the head."""
        units = [Unit("stem", nn.Sequential(self.conv1, self.bn1, self.relu, self.maxpool))]
        for lname in ("layer1", "layer2", "layer3", "layer4"):
            units += [unit_from_module(f"{lname}.{bname}", block)
                      for bname, block in subtree(self, lname).named_children()]
        units.append(Unit("avgpool+fc", nn.Sequential(self.avgpool, nn.Flatten(1), self.fc)))
        return units

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.fc(self.avgpool(x).flatten(1))


@MODEL.register_module()
class ResNet18(ResNet):
    def __init__(self, num_classes: int = 1000, init_cfg=None):
        super().__init__(18, num_classes, init_cfg)


@MODEL.register_module()
class ResNet50(ResNet):
    def __init__(self, num_classes: int = 1000, init_cfg=None):
        super().__init__(50, num_classes, init_cfg)

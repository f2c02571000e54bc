"""VGG A/B/D/E (11/13/16/19 layers) (port of ``convnet_approximater_tpu/models/vgg.py``).

The JAX model flattens its NHWC map in (h, w, c) order; this one flattens the
same way (:func:`~convnet_approximater_tpu_torch.nn.flatten_hwc`), so the
first Linear's 25088 x 4096 weight carries across as it is.
"""

from __future__ import annotations

from torch import nn

from convnet_approximater_tpu_torch.nn import (AdaptiveAvgPool2d, BatchNorm2d, Conv2d, Dropout,
                                               Linear, MaxPool2d, ReLU, flatten_hwc)
from convnet_approximater_tpu_torch.parallel.spatial import gather_rows

from .switchable import MODEL, SwitchableModel

_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
          512, 512, 512, 512, "M"],
}


@MODEL.register_module()
class VGG(SwitchableModel):
    # the classifier's tensor-parallel pair (parallel/tp.py): fc1's sharded
    # features pass the ReLU and the dropout (its mask sliced) to fc2
    TP_CHAINS = (("classifier.0", "classifier.1", "classifier.2", "classifier.3"),)

    def __init__(self, depth: int = 16, num_classes: int = 10, dropout: float = 0.5,
                 batch_norm: bool = False, init_cfg=None):
        super().__init__(init_cfg=init_cfg)
        layers = []
        in_c = 3
        for v in _CFGS[{11: "A", 13: "B", 16: "D", 19: "E"}[depth]]:
            if v == "M":
                layers.append(MaxPool2d(kernel_size=2, stride=2))
                continue
            layers.append(Conv2d(in_c, v, kernel_size=3, padding=1))
            if batch_norm:
                layers.append(BatchNorm2d(v))
            layers.append(ReLU())
            in_c = v
        self.features = nn.Sequential(*layers)
        self.avgpool = AdaptiveAvgPool2d((7, 7))
        self.classifier = nn.Sequential(
            Linear(512 * 7 * 7, 4096),
            ReLU(),
            Dropout(p=dropout),
            Linear(4096, 4096),
            ReLU(),
            Dropout(p=dropout),
            Linear(4096, num_classes),
        )

    def forward(self, x):
        # spatially sharded, the pooled map's rows are gathered whole for the classifier
        return self.classifier(flatten_hwc(gather_rows(self.avgpool(self.features(x)))))


@MODEL.register_module()
class VGG16(VGG):
    def __init__(self, num_classes: int = 10, dropout: float = 0.5, batch_norm: bool = False,
                 init_cfg=None):
        super().__init__(16, num_classes, dropout, batch_norm, init_cfg)

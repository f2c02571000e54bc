"""CIFAR-adapted AlexNet, the scheme-1 workload (port of
``convnet_approximater_tpu/models/alexnet.py``): 5 convs and a
9216 -> 4096 -> 1024 -> ``num_classes`` head.

The JAX model flattens its NHWC map in (h, w, c) order; this one flattens the
same way (:func:`~convnet_approximater_tpu_torch.nn.flatten_hwc`), so the first
Linear takes the JAX package's weights as they are.
"""

from __future__ import annotations

from torch import nn

from convnet_approximater_tpu_torch.nn import (AdaptiveAvgPool2d, Conv2d, Dropout, Linear,
                                               MaxPool2d, ReLU, flatten_hwc)
from convnet_approximater_tpu_torch.parallel.spatial import gather_rows

from .switchable import MODEL, SwitchableModel


@MODEL.register_module()
class AlexNet(SwitchableModel):
    TP_CHAINS = (("classifier.1", "classifier.2", "classifier.3", "classifier.4"),)  # parallel/tp.py

    def __init__(self, num_classes: int = 10, dropout: float = 0.5, init_cfg=None):
        super().__init__(init_cfg=init_cfg)
        self.features = nn.Sequential(
            Conv2d(3, 64, kernel_size=11, stride=4, padding=2),
            ReLU(),
            MaxPool2d(kernel_size=3, stride=2),
            Conv2d(64, 192, kernel_size=5, padding=2),
            ReLU(),
            MaxPool2d(kernel_size=3, stride=2),
            Conv2d(192, 384, kernel_size=3, padding=1),
            ReLU(),
            Conv2d(384, 256, kernel_size=3, padding=1),
            ReLU(),
            Conv2d(256, 256, kernel_size=3, padding=1),
            ReLU(),
            MaxPool2d(kernel_size=3, stride=2),
        )
        self.avgpool = AdaptiveAvgPool2d((6, 6))
        self.classifier = nn.Sequential(
            Dropout(p=dropout),
            Linear(256 * 6 * 6, 4096),
            ReLU(),
            Dropout(p=dropout),
            Linear(4096, 1024),
            ReLU(),
            Linear(1024, num_classes),
        )

    def forward(self, x):
        # spatially sharded, the pooled map's rows are gathered whole for the classifier
        return self.classifier(flatten_hwc(gather_rows(self.avgpool(self.features(x)))))

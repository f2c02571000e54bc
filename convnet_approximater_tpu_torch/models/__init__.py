from .alexnet import AlexNet
from .convnext import ConvNeXt, ConvNeXtBlock, ConvNeXtTiny, LayerScale
from .mscan import MSCAN, MSCAN_Classifier
from .switchable import MODEL, SwitchableModel, build_model

from .alexnet import AlexNet
from .convnext import ConvNeXt, ConvNeXtBlock, ConvNeXtTiny, LayerScale
from .mscan import MSCAN, MSCAN_Classifier
from .resnet import BasicBlock, Bottleneck, ResNet, ResNet18, ResNet50
from .switchable import MODEL, SwitchableModel, build_model
from .vgg import VGG, VGG16

# SegNeXt and SyntheticSeg register on import; imported last, since the
# segmentation package builds on the models above
import convnet_approximater_tpu_torch.segmentation  # noqa: E402,F401

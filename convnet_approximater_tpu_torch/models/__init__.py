from .alexnet import AlexNet
from .mscan import MSCAN, MSCAN_Classifier
from .switchable import MODEL, SwitchableModel, build_model

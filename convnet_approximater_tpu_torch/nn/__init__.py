"""Leaf layers of the port; containers are ``torch.nn``'s own."""

from .layers import (GELU, AdaptiveAvgPool2d, BatchNorm2d, Conv2d, Dropout, GroupNorm,
                     Identity, LayerNorm, Linear, MaxPool2d, ReLU, channels_last,
                     drop_weight_caches, flatten_hwc, frozen_params_keys, gelu, init_weights,
                     params_key)

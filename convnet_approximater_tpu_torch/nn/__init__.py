"""Leaf layers of the port; containers are ``torch.nn``'s own."""

from .layers import (GELU, BatchNorm2d, Conv2d, Dropout, Identity, LayerNorm, Linear,
                     gelu, init_weights)

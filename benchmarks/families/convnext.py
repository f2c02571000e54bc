"""The program's ConvNeXt at a configuration's sizes, dense, on the device,
its parameters still to be filled (``benchkit/weights.py``)."""

from __future__ import annotations

import torch
from torch import nn

from convnet_approximater_tpu_torch.models import ConvNeXt
from convnet_approximater_tpu_torch.models.convnext import ConvNeXtBlock


def build(model: dict, device) -> torch.nn.Module:
    with torch.device("meta"):
        net = ConvNeXt(depths=model["depths"], dims=model["dims"],
                       num_classes=model["num_classes"])
    net = net.to_empty(device=device)
    blocks = [m for m in net.modules() if isinstance(m, ConvNeXtBlock)]
    got = dict(in_channels=net.downsample_layers[0][0].in_channels,
               stem_stride=net.downsample_layers[0][0].stride[0],
               kernel_size={b.dwconv.kernel_size[0] for b in blocks},
               mlp_ratio={b.hidden // b.dim for b in blocks},
               ln_eps={m.eps for m in net.modules() if isinstance(m, nn.LayerNorm)})
    want = dict(in_channels=model["in_channels"], stem_stride=model["stem_stride"],
                kernel_size={model["kernel_size"]}, mlp_ratio={model["mlp_ratio"]},
                ln_eps={model["ln_eps"]})
    if got != want:
        raise ValueError(f"the configuration states {want}, the program's ConvNeXt has {got}")
    return net

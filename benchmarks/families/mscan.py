"""The program's MSCAN classifier at a configuration's sizes, dense, on the
device, its parameters still to be filled (``benchkit/weights.py``)."""

from __future__ import annotations

import torch

from convnet_approximater_tpu_torch.layers import MSCA
from convnet_approximater_tpu_torch.models import MSCAN_Classifier
from convnet_approximater_tpu_torch.models.mscan import FFN
from convnet_approximater_tpu_torch.nn import BatchNorm2d, LayerNorm


def build(model: dict, device) -> torch.nn.Module:
    with torch.device("meta"):
        net = MSCAN_Classifier(in_channels=model["in_channels"],
                               num_channels=model["num_channels"],
                               num_blocks=model["num_blocks"], exp_ratios=model["exp_ratios"],
                               num_classes=model["num_classes"])
    net = net.to_empty(device=device)
    # the sizes the constructor does not take: the configuration has to state the model's own
    got = dict(k1_size={m.k1_size for m in net.modules() if isinstance(m, MSCA)},
               k_sizes={m.k_sizes for m in net.modules() if isinstance(m, MSCA)},
               ffn_kernel={m.dconv.kernel_size[0] for m in net.modules() if isinstance(m, FFN)},
               bn_eps={m.eps for m in net.modules() if isinstance(m, BatchNorm2d)},
               ln_eps={m.eps for m in net.modules() if isinstance(m, LayerNorm)})
    want = dict(k1_size={model["k1_size"]}, k_sizes={tuple(model["k_sizes"])},
                ffn_kernel={model["ffn_kernel"]}, bn_eps={model["bn_eps"]},
                ln_eps={model["ln_eps"]})
    if got != want:
        raise ValueError(f"the configuration states {want}, the program's MSCAN has {got}")
    return net

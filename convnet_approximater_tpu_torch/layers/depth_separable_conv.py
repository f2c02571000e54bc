"""Depthwise strip-conv blocks of MSCA (port of
``convnet_approximater_tpu/layers/depth_separable_conv.py``).

``CascadeConv`` applies a horizontal (1, k) depthwise conv, then a vertical
(k, 1) one; the order matters to MscaRep's border algebra.
"""

from __future__ import annotations

import torch
from torch import nn

from convnet_approximater_tpu_torch.nn import Conv2d, Identity
from convnet_approximater_tpu_torch.ops.msca_fused import fix_strip


class CascadeConv(nn.Module):
    """Depthwise (1, k) then (k, 1).  ``bias`` is the second conv's bias flag,
    ``first_bias`` the first's."""

    def __init__(self, dim: int, kernel_size: int, padding: int, bias: bool,
                 first_bias: bool):
        super().__init__()
        self.dim = dim
        self.kernel_size = kernel_size
        self.conv1 = Conv2d(dim, dim, (1, kernel_size), padding=(0, padding), groups=dim,
                            bias=first_bias)
        self.conv2 = Conv2d(dim, dim, (kernel_size, 1), padding=(padding, 0), groups=dim,
                            bias=bias)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class ParallelConv(nn.Module):
    """Sum of :class:`CascadeConv` branches (+ optional identity branch).

    ``all_bias=True`` gives every conv a bias; otherwise only the last
    branch's second conv has one.  This is both MSCA's original multi-scale
    strip bank (k = 7, 11, 21 + identity) and MscaRep's ``decomp >= 2`` target.
    """

    def __init__(self, dim: int, kernel_sizes, paddings, nbranch: int,
                 all_bias: bool, identity: bool):
        super().__init__()
        self.dim = dim
        if isinstance(kernel_sizes, int):
            kernel_sizes = [kernel_sizes] * nbranch
        if isinstance(paddings, int):
            paddings = [paddings] * nbranch
        if len(kernel_sizes) != nbranch or len(paddings) != nbranch:
            raise ValueError(f"need {nbranch} kernel sizes and paddings, got "
                             f"{kernel_sizes} and {paddings}")
        self.branches = nn.ModuleList([
            CascadeConv(dim, kernel_sizes[i], paddings[i],
                        bias=all_bias or i == nbranch - 1, first_bias=all_bias)
            for i in range(nbranch)
        ])
        if identity:
            self.branches.append(Identity())

    def forward(self, x):
        out = None
        for branch in self.branches:
            y = branch(x)
            out = y if out is None else out + y
        return out


class FixPaddingBias(nn.Module):
    """Learnable residuals on the top and bottom ``padding`` rows.

    ``res`` is (2, C, p): ``res[0]`` runs from the top row down, ``res[1]``
    ends at the bottom row.  Both apply where the two strips overlap
    (maps lower than 2 p).
    """

    def __init__(self, num_channels: int, padding: int):
        super().__init__()
        self.num_channels = num_channels
        self.p = padding
        self.res = nn.Parameter(torch.randn(2, num_channels, padding))

    def init_weights(self, generator: torch.Generator):
        with torch.no_grad():
            self.res.normal_(generator=generator)

    def forward(self, x):
        strip = fix_strip(self.res.transpose(1, 2), x.shape[2])  # (H, C)
        return x + strip.t()[None, :, :, None]

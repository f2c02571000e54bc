"""Exact re-parameterization of MSCA's strip-conv bank (port of
``convnet_approximater_tpu/core/msca_rep.py``).

The ParallelConv bank (identity + per-branch cascade of a horizontal (1, k)
conv, then a vertical (k, 1) conv, each with a bias) merges into one
depthwise kernel with a centre bias and top/bottom border residuals; MscaRep
then re-expands it by batched SVD into ``decomp`` rank-1 cascade branches.
Weights are OIHW, as the published equations are written.

Border bias: the cascade's first bias ``b1`` is uniform after conv1, so conv2
(zero-padded, height ``k = 2p + 1``) maps it to ``b1 * sum(w2)`` inside the map
but to a partial sum within ``p`` rows of the top and bottom edges.  The merged
kernel applies the full centre bias everywhere; the residual at row ``r`` from
the top is ``-b1 * sum(w2[:p-r])``, mirrored at the bottom.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from convnet_approximater_tpu_torch.layers import (MSCA, CascadeConv, FixPaddingBias,
                                                   ParallelConv, Substitution)
from convnet_approximater_tpu_torch.nn import Conv2d, init_weights
from convnet_approximater_tpu_torch.utils.logger import get_logger

from .approximater import APP, Approximater


def sum_bias(w2_c1h1: torch.Tensor, b1: torch.Tensor, b2: torch.Tensor, pad: int = None):
    """Centre bias and border residuals of a biased cascade.

    ``w2_c1h1``: (C, 1, H2, 1) vertical kernel; ``b1``/``b2``: (C,) biases.
    Returns ``(center (C,), res (2, C, p))``, res[0] ordered from the top edge
    inward and res[1] toward the bottom edge.
    """
    h2 = w2_c1h1.shape[2]
    p = h2 // 2 if pad is None else pad
    w2 = w2_c1h1[:, 0, :, 0]  # (C, H2)
    center = w2.sum(dim=1) * b1 + b2
    csum = torch.cumsum(w2, dim=1)[:, :p]  # sum of the first i+1 taps
    rcsum = torch.cumsum(w2.flip(1), dim=1)[:, :p]  # sum of the last i+1 taps
    top = -csum * b1[:, None]
    bot = -rcsum * b1[:, None]
    return center, torch.stack([top.flip(1), bot], dim=0)


def merge_res(res_list: List[torch.Tensor]) -> torch.Tensor:
    """Sum border residuals of different paddings into a (2, C, max_p) array:
    top residues align to the first rows, bottom residues to the last."""
    max_p = max(int(r.shape[-1]) for r in res_list)
    merged = res_list[0].new_zeros(2, res_list[0].shape[1], max_p)
    for r in res_list:
        p = int(r.shape[-1])
        merged[0, :, :p] += r[0]
        merged[1, :, max_p - p:] += r[1]
    return merged


def _pad_center(kernel: torch.Tensor, hw: int) -> torch.Tensor:
    """Zero-pad a (C, 1, h, w) kernel to (C, 1, hw, hw), centred."""
    h, w = kernel.shape[-2:]
    ph, pw = max(hw - h, 0) // 2, max(hw - w, 0) // 2
    return F.pad(kernel, (pw, pw, ph, ph))


def get_equivalent_kernel(module: ParallelConv):
    """Merge a ParallelConv bank (with identity branch) into one kernel.

    Returns ``(weight (C, 1, hw, hw), bias (C,), res (2, C, hw//2))``: the
    identity kernel plus the centre-padded ``w2 @ w1`` of every branch, biases
    through :func:`sum_bias`.
    """
    cascades = [b for b in module.branches if isinstance(b, CascadeConv)]
    C = module.dim
    ref = cascades[0].conv2.weight
    zeros = ref.new_zeros(C)
    hw = max(cascades[-1].conv1.weight.shape[-2:])
    weight = ref.new_zeros(C, 1, hw, hw)
    weight[:, 0, hw // 2, hw // 2] = 1.0  # identity branch
    b_sum = ref.new_zeros(C)
    res_list = []
    for c in cascades:
        w1, w2 = c.conv1.weight, c.conv2.weight  # (C, 1, 1, k), (C, 1, k, 1)
        b1 = c.conv1.bias if c.conv1.bias is not None else zeros
        b2 = c.conv2.bias if c.conv2.bias is not None else zeros
        weight = weight + _pad_center(w2 @ w1, hw)
        b, r = sum_bias(w2, b1, b2)
        b_sum = b_sum + b
        res_list.append(r)
    return weight, b_sum, merge_res(res_list)


@APP.register_module()
class MscaRep(Approximater):
    """Re-parameterize MSCA: merge the strip bank, optionally re-expand it into
    ``decomp`` rank-1 cascades, optionally add the learnable border fix."""

    _src_type = "MSCA"
    _tgt_type = "MSCA"

    def __init__(self, decomp: int, fix: bool, decomp_conv0: bool = False):
        if not 0 <= decomp <= 4:
            raise ValueError(f"decomp must be in 0..4, got {decomp}")
        self.decomp = decomp
        self.fix = fix
        # also split conv0's k1 x k1 kernel into a rank-1 (1, k1) / (k1, 1)
        # cascade by SVD (lossy: logs the retained PC energy)
        self.decomp_conv0 = decomp_conv0

    def _get_tgt_args(self, src: MSCA) -> Dict:
        return dict(num_channel=src.num_channel, k1_size=src.k1_size, k_sizes=src.k_sizes)

    def _fix_substitution(self, sub: Substitution, generator: torch.Generator):
        src: MSCA = sub.old_module
        tgt: MSCA = sub.new_module
        tgt.conv0.load_state_dict(src.conv0.state_dict())
        tgt.channel_mix.load_state_dict(src.channel_mix.state_dict())
        max_k = max(src.k_sizes)
        padding = max_k // 2
        C = src.num_channel
        if self.decomp == 0:
            sd_conv = Conv2d(C, C, max_k, padding=padding, groups=C)
        elif self.decomp == 1:
            sd_conv = CascadeConv(C, max_k, padding, bias=True, first_bias=False)
        else:
            sd_conv = ParallelConv(C, max_k, padding, self.decomp, all_bias=False,
                                   identity=False)
        tgt.sd_convs = nn.Sequential(sd_conv, FixPaddingBias(C, padding)) if self.fix else sd_conv
        init_weights(tgt.sd_convs, generator)
        if self.decomp_conv0:
            k1 = src.k1_size
            tgt.conv0 = CascadeConv(C, k1, k1 // 2, bias=True, first_bias=False)
            init_weights(tgt.conv0, generator)

    @torch.no_grad()
    def optimize(self, sub: Substitution):
        src: MSCA = sub.old_module
        tgt: MSCA = sub.new_module
        weight, bias, res = get_equivalent_kernel(src.sd_convs)
        sd = tgt.sd_convs[0] if self.fix else tgt.sd_convs
        if self.decomp == 0:
            sd.weight.copy_(weight)
            sd.bias.copy_(bias)
        else:
            u, s, vh = torch.linalg.svd(weight, full_matrices=False)  # over (C, 1, k, k)
            # conv1 (1, k): j-th right-singular vector, unscaled;
            # conv2 (k, 1): j-th left-singular vector scaled by s_j
            cascades = [sd] if self.decomp == 1 else list(sd.branches)
            for j, c in enumerate(cascades):
                c.conv1.weight.copy_(vh[..., j, :][..., None, :])
                c.conv2.weight.copy_((u[..., j] * s[..., j][..., None])[..., None])
            cascades[-1].conv2.bias.copy_(bias)
            lbd = s ** 2
            m_pce = torch.mean(lbd[..., :self.decomp].sum(-1) / lbd.sum(-1))
            get_logger().info(f"PC energy retained: {float(m_pce)}")
        if self.fix:
            tgt.sd_convs[1].res.copy_(res)
        if self.decomp_conv0:
            u, s, vh = torch.linalg.svd(src.conv0.weight, full_matrices=False)  # (C, 1, k1, k1)
            tgt.conv0.conv1.weight.copy_(vh[..., 0, :][..., None, :])
            tgt.conv0.conv2.weight.copy_((u[..., 0] * s[..., 0][..., None])[..., None])
            tgt.conv0.conv2.bias.copy_(src.conv0.bias)
            lbd = s ** 2
            pce = torch.mean(lbd[..., 0] / lbd.sum(-1))
            get_logger().info(f"conv0 rank-1 PC energy: {float(pce)}")

    def _postprocess(self, sub: Substitution):
        pass


@APP.register_module()
class MscaProfile(Approximater):
    """Swap MSCA for MSCAProfile (profiler-annotated forward), weights copied."""

    _src_type = "MSCA"
    _tgt_type = "MSCAProfile"

    def _get_tgt_args(self, src: MSCA) -> Dict:
        return dict(num_channel=src.num_channel, k1_size=src.k1_size, k_sizes=src.k_sizes)

    def _fix_substitution(self, sub: Substitution, generator: torch.Generator):
        sub.new.load_state_dict(sub.old.state_dict())

    def optimize(self, sub: Substitution):
        pass

    def _postprocess(self, sub: Substitution):
        pass


@APP.register_module()
class MscaRepProfile(MscaRep):
    """MscaRep targeting the profiler-annotated MSCA variant."""

    _src_type = "MSCA"
    _tgt_type = "MSCAProfile"

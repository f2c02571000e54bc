"""Rank-r separable re-parameterization of depthwise k x k convolutions (port
of ``convnet_approximater_tpu/core/dw_sep_rep.py``).

Per channel, ``W_c (k x k) ~= sum_{j<r} s_j u_j v_j^T`` from an SVD on the
weights' device, so a depthwise conv becomes r cascades of a (1, k) conv (taps
``v_j``) then a (k, 1) conv (taps ``s_j u_j``): a :class:`CascadeConv` at
r = 1, a :class:`ParallelConv` of r branches above.  The source's bias goes on
the last branch's second conv.  The solve is exact at r = k and logs the
retained PC energy.  ConvNeXt's 7x7 ``dwconv`` is the motivating target.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from convnet_approximater_tpu_torch.layers import CascadeConv, ParallelConv, Substitution
from convnet_approximater_tpu_torch.nn import Conv2d
from convnet_approximater_tpu_torch.utils.logger import get_logger

from .approximater import APP, Approximater


@APP.register_module()
class DwSepRep(Approximater):
    _src_type = Conv2d

    def __init__(self, ranks=None, energy: Optional[float] = None, strip_matmul: bool = False,
                 deploy: bool = False):
        super().__init__(deploy=deploy)
        # ranks: one int for every layer, or one per switchable layer in order;
        # or energy = tau: per layer, the smallest r whose mean retained
        # per-channel spectral energy is >= tau.  strip_matmul picks an XLA
        # lowering in the JAX package and means nothing here.
        if (ranks is None) == (energy is None):
            raise ValueError("give exactly one of ranks / energy")
        if energy is not None and not 0.0 < energy <= 1.0:
            raise ValueError(f"energy must be in (0, 1], got {energy}")
        self.ranks = ranks if isinstance(ranks, (int, type(None))) else tuple(ranks)
        self.energy = energy
        self._auto_r = None
        self._idx = 0

    def initialize(self, src, generator: Optional[torch.Generator] = None):
        if self.energy is not None:
            s = torch.linalg.svdvals(src.weight.detach().float())  # (C, 1, k)
            lbd = (s ** 2)[:, 0, :]
            cum = torch.cumsum(lbd, dim=1) / lbd.sum(dim=1, keepdim=True).clamp_min(1e-30)
            mean_cum = cum.mean(dim=0)
            k = mean_cum.shape[0]
            r = int(torch.searchsorted(mean_cum, torch.tensor([self.energy], device=s.device)))
            self._auto_r = min(r + 1, k)
            get_logger().info(f"auto rank: {self._auto_r}/{k} (mean channel energy >= "
                              f"{self.energy})")
        return super().initialize(src, generator)

    def _cur_rank(self) -> int:
        if self.energy is not None:
            return self._auto_r
        if isinstance(self.ranks, int):
            return self.ranks
        return self.ranks[self._idx]

    @property
    def tgt_type(self) -> type:
        return CascadeConv if self._cur_rank() == 1 else ParallelConv

    def _get_tgt_args(self, src: Conv2d) -> Dict:
        if not src.groups == src.in_channels == src.out_channels:
            raise ValueError(f"DwSepRep substitutes depthwise convs only (use "
                             f"DepthwiseConvFilter); got groups={src.groups} "
                             f"in={src.in_channels} out={src.out_channels}")
        kh, kw = src.kernel_size
        if not (kh == kw and src.stride == (1, 1) and src.dilation == (1, 1)):
            raise ValueError(f"square stride-1 undilated kernels only (k={src.kernel_size}, "
                             f"stride={src.stride}, dilation={src.dilation})")
        r = self._cur_rank()
        if not 1 <= r <= kh:
            raise ValueError(f"rank {r} out of range for k={kh}")
        if r == 1:
            # the bias always on conv2: a bias-less source carries zeros
            return dict(dim=src.in_channels, kernel_size=kh, padding=src.padding[0], bias=True,
                        first_bias=False)
        return dict(dim=src.in_channels, kernel_sizes=kh, paddings=src.padding[0], nbranch=r,
                    all_bias=False, identity=False)

    def _fix_substitution(self, sub: Substitution, generator: torch.Generator):
        self._idx += 1  # one initialize() per matched layer, in registration order

    @torch.no_grad()
    def optimize(self, sub: Substitution):
        src, tgt = sub.old_module, sub.new_module
        w = src.weight  # (C, 1, k, k)
        bias = src.bias if src.bias is not None else w.new_zeros(w.shape[0])
        u, s, vh = torch.linalg.svd(w, full_matrices=False)
        cascades = [tgt] if isinstance(tgt, CascadeConv) else list(tgt.branches)
        for j, c in enumerate(cascades):
            c.conv1.weight.copy_(vh[..., j, :][..., None, :])
            c.conv2.weight.copy_((u[..., j] * s[..., j][..., None])[..., None])
        cascades[-1].conv2.bias.copy_(bias)
        lbd = s ** 2
        r = len(cascades)
        pce = torch.mean(lbd[..., :r].sum(-1) / lbd.sum(-1).clamp_min(1e-30))
        get_logger().info(f"PC Energy = {float(pce)}")

    def _postprocess(self, sub: Substitution):
        pass

    def rewind(self):
        """Reset the per-layer rank cursor for a second registration pass."""
        self._idx = 0

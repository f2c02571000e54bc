"""Scheme-1 low-rank expansion approximater (port of ``LowRankExpV1`` in
``convnet_approximater_tpu/core/low_rank_exp.py``, arXiv 1405.3866).

Each switchable ``Conv2d`` (N, C, d, d) becomes a ``LowRankExpConvV1`` with M
spatial bases shared by all input channels: W (N*C, d*d) ~= A (N*C, M) B (M, d*d),
from an SVD, 'standard' or random init, refined by the proximal-IRLS solve
under a lambda continuation when ``max_iter > 0``.  The solves run on the
weights' device.
"""

from __future__ import annotations

from typing import Dict

import torch

from convnet_approximater_tpu_torch.layers import LowRankExpConvV1, Substitution
from convnet_approximater_tpu_torch.nn import Conv2d
from convnet_approximater_tpu_torch.utils.logger import get_logger

from . import low_rank_solvers as solvers
from .approximater import APP, Approximater


@APP.register_module()
class LowRankExpV1(Approximater):
    _src_type = Conv2d
    _tgt_type = "LowRankExpConvV1"

    def __init__(self, num_bases=None, max_iter: int = 0, lmda_length: int = 1,
                 min_lmda: float = 0.0, max_lmda: float = 0.0, energy: float = None,
                 init_method: str = "svd", inc_rate: float = 1.5, do_decomp: bool = False,
                 init_decomp: bool = False, epsilon: float = 1e-3):
        # num_bases: one M per switchable layer, in order; or energy = tau: the
        # smallest M that keeps tau of the stacked filters' spectral energy
        if (num_bases is None) == (energy is None):
            raise ValueError("give exactly one of num_bases / energy")
        if energy is not None and not 0.0 < energy <= 1.0:
            raise ValueError(f"energy must be in (0, 1], got {energy}")
        if not max_lmda >= min_lmda >= 0.0:
            raise ValueError(f"need max_lmda >= min_lmda >= 0, got {min_lmda}, {max_lmda}")
        if init_method not in ("standard", "svd", "random"):
            raise ValueError(f"unknown init_method {init_method!r}")
        self.num_bases = num_bases
        self.energy = energy
        self._auto_m = None
        self.curr = 0
        self.max_iter = max_iter
        self.lmda_list = solvers.lmda_schedule(lmda_length, min_lmda, max_lmda, inc_rate)
        self.do_decomp = do_decomp
        self.init_decomp = init_decomp
        self.init_method = init_method
        self.epsilon = epsilon
        self.objectives = []  # the last optimize()'s objective trace, over all lambdas
        self.pc_energy = None  # and its PC energy after the last lambda

    @staticmethod
    def _stacked(conv: Conv2d) -> torch.Tensor:
        N, C, kh, kw = conv.weight.shape
        if kh != kw:
            raise ValueError(f"LowRankExpV1 needs square kernels, got {kh}x{kw}")
        return conv.weight.detach().float().reshape(N * C, kh * kw)

    @torch.no_grad()
    def initialize(self, src, generator=None):
        if self.energy is not None:
            lbd = torch.linalg.svdvals(self._stacked(src)) ** 2
            cum = torch.cumsum(lbd, 0) / torch.clamp(lbd.sum(), min=1e-30)
            tau = torch.tensor(self.energy, dtype=cum.dtype, device=cum.device)
            self._auto_m = min(int(torch.searchsorted(cum, tau)) + 1, cum.shape[0])
            get_logger().info(f"auto bases: {self._auto_m}/{lbd.shape[0]} "
                              f"(energy >= {self.energy})")
        return super().initialize(src, generator)

    def _get_tgt_args(self, src: Conv2d) -> Dict:
        if self.energy is not None:
            num_base = self._auto_m
        else:
            num_base = self.num_bases[self.curr]
            self.curr += 1
        return dict(in_channels=src.in_channels, out_channels=src.out_channels,
                    num_base=num_base, kernel_size=src.kernel_size, stride=src.stride,
                    padding=src.padding, decomp=self.init_decomp)

    @torch.no_grad()
    def _fix_substitution(self, sub: Substitution, generator: torch.Generator):
        # the source conv's bias goes onto the 1x1 mixing conv; a bias-less
        # source approximates to a zero bias
        bias = sub.old_module.bias
        d_bias = sub.new_module.d_conv.bias
        d_bias.copy_(bias if bias is not None else torch.zeros_like(d_bias))

    @torch.no_grad()
    def optimize(self, sub: Substitution):
        if self.init_decomp:
            return  # the separable target was built directly; its weights come from a checkpoint
        logger = get_logger()
        src: Conv2d = sub.old_module
        tgt: LowRankExpConvV1 = sub.new_module
        N, C, d = src.weight.shape[:3]
        M = tgt.num_base
        W = self._stacked(src)
        if self.init_method == "svd":
            A, B = solvers.svd_init(W, M)
        elif self.init_method == "standard":
            A, B = solvers.standard_init(W, M)
        else:
            A, B = solvers.random_init(torch.Generator().manual_seed(0), W, M)

        logger.info(f"lambda list: {self.lmda_list}")
        self.objectives = []
        for lmda in self.lmda_list:
            prev = None
            for it in range(1, self.max_iter + 1):
                A, B, objs = solvers.als_l21_nuclear(W, A, B, float(lmda), d, 1)
                obj = float(objs[0])
                self.objectives.append(obj)
                logger.info(f"[lmda: {lmda}]({it}/{self.max_iter}) total error: {obj}")
                if prev is not None and abs(prev - obj) < self.epsilon:
                    logger.info(f"[lmda: {lmda}] converged after {it} iters")
                    break
                prev = obj
            self.pc_energy = float(solvers.pc_energy(B, d))
            logger.info(f"PC Energy = {self.pc_energy}")

        # s_conv: the M bases replicated over the C groups (output channel
        # c*M + m = basis m on input channel c); d_conv: (N, C*M) mixing weights
        bases = B.reshape(M, d, d)
        s_w = bases[None].expand(C, M, d, d).reshape(C * M, 1, d, d)
        tgt.s_conv.weight.copy_(s_w)
        tgt.d_conv.weight.copy_(A.reshape(N, C * M)[:, :, None, None])

    def _postprocess(self, sub: Substitution):
        if self.do_decomp:
            sub.new_module.decomp()

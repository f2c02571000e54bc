"""Low-rank expansion approximaters (port of
``convnet_approximater_tpu/core/low_rank_exp.py``, arXiv 1405.3866).

Each switchable ``Conv2d`` (N, C, d, d) becomes a ``LowRankExpConvV1`` with M
spatial bases shared by all input channels: W (N*C, d*d) ~= A (N*C, M) B (M, d*d),
from an SVD, 'standard' or random init, refined by the proximal-IRLS solve
under a lambda continuation when ``max_iter > 0``.

``LowRankExpV2`` (scheme 2), ``LowRankExpV3`` (channel rank, Tucker-1) and
``LowRankExpV4`` (Tucker-2) solve in closed form, optionally weighted by a
calibration second moment (``set_calibration``, which
:class:`~convnet_approximater_tpu_torch.hooks.CalibrationHook` calls with the
statistic the app names in ``calibration_stat``).  Calibrations and ranks are
indexed by the switchable site, in the order ``optimize`` sees them;
``rewind`` restarts both cursors.  The solves run on the weights' device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from convnet_approximater_tpu_torch.layers import (LowRankExpConvV1, LowRankExpConvV2,
                                                   Substitution)
from convnet_approximater_tpu_torch.nn import Conv2d
from convnet_approximater_tpu_torch.utils.logger import get_logger

from . import low_rank_solvers as solvers
from .approximater import APP, Approximater


def energy_rank(W: torch.Tensor, energy: float) -> int:
    """The smallest rank whose leading singular values of ``W`` keep ``energy`` of
    its spectral energy: a left-side ``searchsorted`` on the cumulative energy,
    clamped to the spectrum (float32 rounding can leave the last cumulative
    value just below an energy of 1)."""
    lbd = torch.linalg.svdvals(W) ** 2
    cum = torch.cumsum(lbd, 0) / torch.clamp(lbd.sum(), min=1e-30)
    tau = torch.tensor(energy, dtype=cum.dtype, device=cum.device)
    return min(int(torch.searchsorted(cum, tau)) + 1, cum.shape[0])


def _check_rank_args(num_bases, energy):
    if (num_bases is None) == (energy is None):
        raise ValueError("give exactly one of num_bases / energy")
    if energy is not None and not 0.0 < energy <= 1.0:
        raise ValueError(f"energy must be in (0, 1], got {energy}")


def _carry_bias(sub: Substitution, tail: str):
    """The source conv's bias onto the target's ``tail`` conv; a bias-less
    source approximates to a zero bias."""
    bias = sub.old_module.bias
    t_bias = getattr(sub.new_module, tail).bias
    t_bias.copy_(bias if bias is not None else torch.zeros_like(t_bias))


def _check_dense(app: str, src: Conv2d):
    if src.groups != 1 or src.dilation != (1, 1):
        raise ValueError(f"{app} factorizes dense convs only (use SimpleConvFilter or "
                         f"KernelSizeFilter); got groups={src.groups} dilation={src.dilation}")


def _oihw(src: Conv2d) -> torch.Tensor:
    return src.weight.detach().float().contiguous()


def _sym_sqrt_parts(xcov: torch.Tensor, ridge: float):
    """``(Q, sqrt(lam))`` of the eigendecomposition of a PSD second moment, its
    eigenvalues clipped at ``ridge`` times the largest, in float32.  The
    decomposition runs in float64: LAPACK's float32 ``syevd`` can fail to
    converge on the rank-deficient moment of a small calibration set (many
    zero eigenvalues), which the clipping is there to handle."""
    lam, Q = torch.linalg.eigh(xcov.double())
    lam = torch.clamp(lam, min=float(ridge) * lam.max())
    return Q.float(), lam.sqrt().float()


@APP.register_module()
class LowRankExpV1(Approximater):
    _src_type = Conv2d
    _tgt_type = "LowRankExpConvV1"

    def __init__(self, num_bases=None, max_iter: int = 0, lmda_length: int = 1,
                 min_lmda: float = 0.0, max_lmda: float = 0.0, energy: float = None,
                 init_method: str = "svd", inc_rate: float = 1.5, do_decomp: bool = False,
                 init_decomp: bool = False, epsilon: float = 1e-3, deploy: bool = False):
        super().__init__(deploy=deploy)
        # num_bases: one M per switchable layer, in order; or energy = tau: the
        # smallest M that keeps tau of the stacked filters' spectral energy
        _check_rank_args(num_bases, energy)
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

    def rewind(self):
        self.curr = 0

    @staticmethod
    def _stacked(conv: Conv2d) -> torch.Tensor:
        N, C, kh, kw = conv.weight.shape
        if kh != kw:
            raise ValueError(f"LowRankExpV1 needs square kernels, got {kh}x{kw}")
        return conv.weight.detach().float().reshape(N * C, kh * kw)

    @torch.no_grad()
    def initialize(self, src, generator=None):
        if self.energy is not None:
            W = self._stacked(src)
            self._auto_m = energy_rank(W, self.energy)
            get_logger().info(f"auto bases: {self._auto_m}/{min(W.shape)} "
                              f"(energy >= {self.energy})")
        return super().initialize(src, generator)

    def _get_tgt_args(self, src: Conv2d) -> Dict:
        if self.energy is not None:
            num_base = self._auto_m
        else:
            num_base = self.num_bases[self.curr]
            self.curr += 1
        # deploy builds the served form, the one the checkpoint was saved in: a
        # do_decomp run saves its layers after decomp()
        return dict(in_channels=src.in_channels, out_channels=src.out_channels,
                    num_base=num_base, kernel_size=src.kernel_size, stride=src.stride,
                    padding=src.padding,
                    decomp=self.init_decomp or (self.deploy and self.do_decomp))

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


class _CalibratedApp(Approximater):
    """A rank cursor and per-site calibration moments, shared by V2-V4."""

    def __init__(self, num_bases, deploy: bool = False):
        super().__init__(deploy=deploy)
        self.num_bases = num_bases
        self.curr = 0
        self._opt_curr = 0
        self._xcov: Dict[int, torch.Tensor] = {}

    def set_calibration(self, index: int, xcov: torch.Tensor):
        self._xcov[index] = xcov

    def rewind(self):
        self.curr = 0
        self._opt_curr = 0

    def _next_rank(self):
        num_base = self.num_bases[self.curr]
        self.curr += 1
        return num_base

    def _next_site(self) -> int:
        index = self._opt_curr
        self._opt_curr += 1
        return index

    def _postprocess(self, sub: Substitution):
        pass


@APP.register_module()
class LowRankExpV2(_CalibratedApp):
    """Scheme-2 separable reconstruction ``W[n, c] ~= sum_m v_m^c (h_n^m)^T``: the
    truncated SVD of the stacked kernel, then ``data_driven_iters`` ALS
    iterations under the site's strip second moment (the identity when the site
    has none)."""

    _src_type = Conv2d
    _tgt_type = "LowRankExpConvV2"
    calibration_stat = "strips"

    def __init__(self, num_bases, data_driven_iters: int = 0, deploy: bool = False):
        super().__init__(num_bases, deploy=deploy)
        self.data_driven_iters = data_driven_iters
        self.energy_kept = None  # the last optimize()'s retained energy
        self.errors = None  # and its ALS errors

    def _get_tgt_args(self, src: Conv2d) -> Dict:
        return dict(in_channels=src.in_channels, out_channels=src.out_channels,
                    num_base=self._next_rank(), kernel_size=src.kernel_size, stride=src.stride,
                    padding=src.padding)

    @torch.no_grad()
    def _fix_substitution(self, sub: Substitution, generator: torch.Generator):
        _carry_bias(sub, "h_conv")

    @torch.no_grad()
    def optimize(self, sub: Substitution):
        logger = get_logger()
        index = self._next_site()
        tgt: LowRankExpConvV2 = sub.new_module
        W = _oihw(sub.old_module)
        N, C, kh, kw = W.shape
        V, H, energy = solvers.scheme2_factorize(W, tgt.num_base)
        self.energy_kept = float(energy)
        logger.info(f"scheme-2 retained energy: {self.energy_kept:.6f}")
        self.errors = None
        if self.data_driven_iters > 0:
            xcov = self._xcov.get(index)
            if xcov is None:
                xcov = torch.eye(C * kh, dtype=torch.float32, device=W.device)
            V, H, errs = solvers.scheme2_data_driven(W, V, H, xcov.to(W.device).float(),
                                                     self.data_driven_iters)
            self.errors = errs
            logger.info(f"scheme-2 ALS final err: {float(errs[-1]):.6f}")
        tgt.v_conv.weight.copy_(V[:, :, :, None])
        tgt.h_conv.weight.copy_(H[:, :, None, :])


@APP.register_module()
class LowRankExpV3(_CalibratedApp):
    """Channel-rank factorization ``W (N, C k^2) ~= A (N, r) B (r, C k^2)``: a
    dense k x k conv C -> r, then a 1x1 conv r -> N.  The truncated SVD is the
    Frobenius-optimal solve; with ``data_driven`` and a site's patch second
    moment Sigma it is the truncated SVD of ``W Sigma^(1/2)``, un-whitened
    through ``Sigma^(-1/2)`` (eigenvalues clipped at ``ridge`` times the
    largest), which minimizes the response error ``E||y - yhat||^2``."""

    _src_type = Conv2d
    _tgt_type = "LowRankExpConvV3"
    calibration_stat = "patches"

    def __init__(self, num_bases=None, energy: float = None, data_driven: bool = False,
                 ridge: float = 1e-6, deploy: bool = False):
        _check_rank_args(num_bases, energy)
        super().__init__(num_bases, deploy=deploy)
        self.energy = energy
        self.data_driven = data_driven
        self.ridge = ridge
        self._auto_r = None
        self.pc_energy = None  # the last optimize()'s retained energy

    @torch.no_grad()
    def initialize(self, src, generator=None):
        if self.energy is not None:
            W = _oihw(src).reshape(src.out_channels, -1)
            self._auto_r = energy_rank(W, self.energy)
            get_logger().info(f"auto rank: {self._auto_r}/{min(W.shape)} "
                              f"(energy >= {self.energy})")
        return super().initialize(src, generator)

    def _get_tgt_args(self, src: Conv2d) -> Dict:
        _check_dense("LowRankExpV3", src)
        num_base = self._auto_r if self.energy is not None else self._next_rank()
        return dict(in_channels=src.in_channels, out_channels=src.out_channels,
                    num_base=num_base, kernel_size=src.kernel_size, stride=src.stride,
                    padding=src.padding)

    @torch.no_grad()
    def _fix_substitution(self, sub: Substitution, generator: torch.Generator):
        _carry_bias(sub, "mix_conv")

    @torch.no_grad()
    def optimize(self, sub: Substitution):
        logger = get_logger()
        index = self._next_site()
        W4 = _oihw(sub.old_module)
        N, C, kh, kw = W4.shape
        r = sub.new_module.num_base
        W = W4.reshape(N, C * kh * kw)
        xcov = self._xcov.get(index) if self.data_driven else None
        if xcov is not None:
            Q, sq = _sym_sqrt_parts(xcov.to(W.device), self.ridge)
            u, s, vh = torch.linalg.svd(W @ (Q * sq[None, :]) @ Q.T, full_matrices=False)
            A = u[:, :r]
            B = (s[:r, None] * vh[:r]) @ Q @ (Q / sq[None, :]).T
            logger.info(f"data-driven whitened solve (xcov index {index}, D={C * kh * kw})")
        else:
            A, B = solvers.svd_init(W, r)
            s = torch.linalg.svdvals(W)
        lbd = s ** 2
        self.pc_energy = float(lbd[:r].sum() / torch.clamp(lbd.sum(), min=1e-30))
        sub.new_module.basis_conv.weight.copy_(B.reshape(r, C, kh, kw))
        sub.new_module.mix_conv.weight.copy_(A[:, :, None, None])
        logger.info(f"PC Energy = {self.pc_energy}")


@APP.register_module()
class LowRankExpV4(_CalibratedApp):
    """Tucker-2 factorization ``W ~= G x_O U_N x_I U_C``: a 1x1 conv C -> r1, a
    dense k x k core r1 -> r2, a 1x1 conv r2 -> N.  HOSVD init (the truncated
    SVD of each channel-mode unfolding), then ``hooi_iters`` HOOI sweeps.  With
    ``data_driven`` and a site's channel second moment Sigma_c the input mode
    is whitened by ``Sigma_c^(1/2)`` first and its factor un-whitened after."""

    _src_type = Conv2d
    _tgt_type = "LowRankExpConvV4"
    calibration_stat = "channels"

    def __init__(self, num_bases=None, energy: float = None, hooi_iters: int = 3,
                 data_driven: bool = False, ridge: float = 1e-6, deploy: bool = False):
        _check_rank_args(num_bases, energy)
        super().__init__(num_bases, deploy=deploy)
        self.energy = energy
        self.hooi_iters = int(hooi_iters)
        self.data_driven = data_driven
        self.ridge = ridge
        self._auto_r: Optional[Tuple[int, int]] = None
        self.pc_energy = None  # the last optimize()'s retained energy

    @staticmethod
    def _unfoldings(W4: torch.Tensor):
        """The output-mode (N, C k^2) and input-mode (C, N k^2) unfoldings."""
        N, C = W4.shape[:2]
        return W4.reshape(N, -1), W4.transpose(0, 1).reshape(C, -1)

    @torch.no_grad()
    def initialize(self, src, generator=None):
        if self.energy is not None:
            W_out, W_in = self._unfoldings(_oihw(src))
            r2, r1 = energy_rank(W_out, self.energy), energy_rank(W_in, self.energy)
            self._auto_r = (r1, r2)
            get_logger().info(f"auto ranks: r1={r1}/{min(W_in.shape)} r2={r2}/"
                              f"{min(W_out.shape)} (mode energy >= {self.energy})")
        return super().initialize(src, generator)

    def _get_tgt_args(self, src: Conv2d) -> Dict:
        _check_dense("LowRankExpV4", src)
        num_base = self._auto_r if self.energy is not None else self._next_rank()
        return dict(in_channels=src.in_channels, out_channels=src.out_channels,
                    num_base=num_base, kernel_size=src.kernel_size, stride=src.stride,
                    padding=src.padding)

    @torch.no_grad()
    def _fix_substitution(self, sub: Substitution, generator: torch.Generator):
        _carry_bias(sub, "out_conv")

    @staticmethod
    def _left_sv(M: torch.Tensor, r: int) -> torch.Tensor:
        return torch.linalg.svd(M, full_matrices=False)[0][:, :r]

    @torch.no_grad()
    def optimize(self, sub: Substitution):
        logger = get_logger()
        index = self._next_site()
        W4 = _oihw(sub.old_module)
        N, C, kh, kw = W4.shape
        r1, r2 = sub.new_module.num_base
        xcov = self._xcov.get(index) if self.data_driven else None
        inv_half = None
        if xcov is not None:
            Q, sq = _sym_sqrt_parts(xcov.to(W4.device), self.ridge)
            s_half = (Q * sq[None, :]) @ Q.T
            inv_half = (Q / sq[None, :]) @ Q.T
            W4 = torch.einsum("ncuv,cd->nduv", W4, s_half)
            logger.info(f"data-driven channel-whitened solve (xcov index {index}, C={C})")
        W_out, W_in = self._unfoldings(W4)
        U_N = self._left_sv(W_out, r2)
        U_C = self._left_sv(W_in, r1)
        for _ in range(self.hooi_iters):
            T = torch.einsum("ncuv,ca->nauv", W4, U_C)
            U_N = self._left_sv(T.reshape(N, -1), r2)
            S = torch.einsum("ncuv,nb->cbuv", W4, U_N)
            U_C = self._left_sv(S.reshape(C, -1), r1)
        G = torch.einsum("ncuv,nb,ca->bauv", W4, U_N, U_C)  # (r2, r1, kh, kw)
        self.pc_energy = float((G ** 2).sum() / torch.clamp((W4 ** 2).sum(), min=1e-30))
        if inv_half is not None:
            U_C = inv_half @ U_C
        tgt = sub.new_module
        tgt.in_conv.weight.copy_(U_C.T[:, :, None, None])
        tgt.core_conv.weight.copy_(G)
        tgt.out_conv.weight.copy_(U_N[:, :, None, None])
        logger.info(f"PC Energy = {self.pc_energy}")

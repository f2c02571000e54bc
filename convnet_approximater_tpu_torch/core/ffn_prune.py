"""FfnPrune / MlpPrune / AttnPrune: structured hidden-channel pruning of a
block's inner width (port of ``convnet_approximater_tpu/core/ffn_prune.py``).

The hidden width ``M`` of an MLP is the output width of its expansion and the
reduction width of its projection, so keeping ``k < M`` hidden channels makes
the same dense ops smaller:

* ``FfnPrune``: MSCAN's conv-FFN (``fc1 1x1 -> dconv 3x3 -> GELU -> fc2 1x1``);
* ``MlpPrune``: ConvNeXt's block MLP (``pwconv1 -> GELU -> pwconv2``), the
  whole block substituted with dwconv, norm and ``gamma`` carried;
* ``AttnPrune``: the gated MSCA branch of ``SpatialAttention`` (``proj_1``,
  conv0, the strip bank, ``channel_mix`` and ``proj_2`` under one mask).

The kept width ``k`` is fixed at ``initialize`` from weight-only importance
(the product of the norms touching channel m), by ``keep``, ``keep_ratio`` or
``energy``, snapped by ``round_to``.  With calibration maps (``CalibrationHook``,
``calibration_stat = "raw"``) ``optimize`` picks the kept set by greedy forward
selection on the measured, centered hidden covariance (:func:`_greedy_select`,
float64 numpy on the host) and refits the projection in closed form: the
augmented normal equations of ``min E||(W2 h + b2) - (W2' h_S + b2')||^2`` with
the hidden second moment and mean (He et al., ICCV'17, eq. 1).  Without
calibration it keeps the ``k`` channels of largest weight importance, sliced.
Exact at ``k = M``.  The moments and the solve run on the weights' device, in
float32; the hidden maps are flattened in (n, h, w) order with channels last,
as the JAX package flattens its NHWC maps.  Weights are OIHW (a conv) and
``(out, in)`` (a Linear) here, where the JAX package's are HWIO and ``(in, out)``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from convnet_approximater_tpu_torch.layers import Substitution
from convnet_approximater_tpu_torch.layers.depth_separable_conv import CascadeConv
from convnet_approximater_tpu_torch.models.convnext import ConvNeXtBlock
from convnet_approximater_tpu_torch.models.mscan import FFN, SpatialAttention
from convnet_approximater_tpu_torch.nn import gelu
from convnet_approximater_tpu_torch.utils.logger import get_logger

from .approximater import APP, Approximater


def _greedy_select(K, T, k: int, eps: float = 1e-12):
    """Greedy forward selection (orthogonal matching pursuit on the hidden
    covariance): the ``k`` channels that explain the most output variance.

    ``K``: (M, M) centered covariance of the hidden channels; ``T``: (M, C) its
    cross-covariance with the outputs ``y = W2^T h``.  Returns the kept set
    (ascending) and the explained-variance sum.
    """
    R = np.array(K, np.float64, copy=True)
    Tr = np.array(T, np.float64, copy=True)
    sel: list = []
    explained = 0.0
    for _ in range(k):
        d = np.diag(R).copy()
        floor = eps * max(float(np.max(d, initial=0.0)), 1e-30)
        gains = np.where(d > floor, (Tr ** 2).sum(axis=1) / np.maximum(d, floor), -np.inf)
        if sel:
            gains[np.array(sel)] = -np.inf
        j = int(np.argmax(gains))
        if not np.isfinite(gains[j]) or gains[j] <= 0.0:
            # the target is explained (or only degenerate channels are left):
            # fill the remaining slots by residual variance
            order = np.argsort(-d, kind="stable")
            rest = [int(i) for i in order if i not in sel][: k - len(sel)]
            sel.extend(rest)
            break
        sel.append(j)
        explained += float(gains[j])
        col = R[:, j].copy()
        Tr -= np.outer(col / d[j], Tr[j])
        R -= np.outer(col, col) / d[j]
    return np.sort(np.asarray(sel[:k], dtype=np.int64)), explained


def _norms(w: torch.Tensor, dims) -> torch.Tensor:
    return torch.sqrt((w.detach().float() ** 2).sum(dim=dims))


def _take_into(dst: nn.Module, src: nn.Module, idx: torch.Tensor, square: bool = False):
    """``dst.weight`` and ``dst.bias`` from ``src``'s output rows ``idx`` (and
    input columns ``idx`` too when ``square``); a source without a bias leaves
    none."""
    w = src.weight.index_select(0, idx)
    dst.weight.copy_(w.index_select(1, idx) if square else w)
    if src.bias is None:
        dst.bias = None
    else:
        dst.bias.copy_(src.bias.index_select(0, idx))


def _flat_channels_last(h: torch.Tensor) -> torch.Tensor:
    """(n, M) rows of an NCHW map in the JAX package's NHWC order."""
    return h.permute(0, 2, 3, 1).reshape(-1, h.shape[1])


@APP.register_module()
class FfnPrune(Approximater):
    _src_type = FFN
    _tgt_type = FFN
    # CalibrationHook hands over the tapped maps themselves: the hidden moments
    # lie behind the expansion and GELU, where no input moment reaches
    calibration_stat = "raw"

    def __init__(self, keep=None, keep_ratio=None, energy: float = None, refit: bool = True,
                 ridge: float = 1e-6, round_to: int = None, deploy: bool = False):
        super().__init__(deploy=deploy)
        given = sum(x is not None for x in (keep, keep_ratio, energy))
        if given != 1:
            raise ValueError("give exactly one of keep / keep_ratio / energy")
        if round_to is not None and round_to < 1:
            raise ValueError(f"round_to must be at least 1, got {round_to}")
        if energy is not None and not 0.0 < energy <= 1.0:
            raise ValueError(f"energy must be in (0, 1], got {energy}")
        if keep_ratio is not None and not isinstance(keep_ratio, (list, tuple)) \
                and not 0.0 < keep_ratio <= 1.0:
            raise ValueError(f"keep_ratio must be in (0, 1], got {keep_ratio}")
        self.keep = tuple(keep) if isinstance(keep, (list, tuple)) else keep
        self.keep_ratio = (tuple(keep_ratio) if isinstance(keep_ratio, (list, tuple))
                           else keep_ratio)
        self.energy = energy
        self.refit = refit
        self.ridge = ridge
        self.round_to = round_to
        self._init_curr = 0  # per-site cursor of a tuple keep / keep_ratio
        self._opt_curr = 0   # pairs optimize() calls with their calibration maps
        self._raw: Dict[int, torch.Tensor] = {}

    def set_calibration(self, index: int, x: torch.Tensor):
        self._raw[index] = x

    def rewind(self):
        self._init_curr = 0
        self._opt_curr = 0

    # -- structure ----------------------------------------------------------
    def _num_keep(self, src: nn.Module) -> int:
        M = self._hidden_dim(src)
        if self.energy is not None:
            imp = self._weight_imp(src).cpu().numpy()
            e = np.sort(imp ** 2)[::-1]
            cum = np.cumsum(e) / max(float(e.sum()), 1e-30)
            k = int(np.searchsorted(cum, self.energy)) + 1
            k = self._round(min(k, M), M)
            get_logger().info(f"auto keep: {k}/{M} (importance energy >= {self.energy})")
            return k
        if self.keep is not None:
            k = self.keep if isinstance(self.keep, int) else self.keep[self._init_curr]
        else:
            r = (self.keep_ratio[self._init_curr] if isinstance(self.keep_ratio, tuple)
                 else self.keep_ratio)
            k = int(round(M * r))
        if not 1 <= k <= M:
            raise ValueError(f"keep {k} out of range for hidden dim {M}")
        return self._round(k, M)

    def _round(self, k: int, M: int) -> int:
        # Python's round: half to even, so 2.5 tiles round to 2
        if not self.round_to or M <= self.round_to:
            return k
        r = self.round_to
        return min(M, max(r, int(round(k / r)) * r))

    def initialize(self, src: nn.Module, generator=None):
        self._k = self._num_keep(src)
        return super().initialize(src, generator)

    def _fix_substitution(self, sub: Substitution, generator: torch.Generator):
        self._init_curr += 1

    # -- solve --------------------------------------------------------------
    def _warn_rank(self, n: int, M: int):
        if n < M:
            get_logger().warning(
                f"calibration sample ({n} pixels) is smaller than the hidden dim ({M}): the "
                f"covariance is rank-deficient — selection quality degrades past rank {n}; "
                f"raise the CalibrationHook num_batches/batch_size")

    @torch.no_grad()
    def optimize(self, sub: Substitution):
        logger = get_logger()
        index = self._opt_curr
        self._opt_curr += 1
        src, tgt = sub.old_module, sub.new_module
        M, k = self._hidden_dim(src), self._hidden_dim(tgt)
        W2, b2 = self._consumer(src)  # (M, C), (C,) float32
        x = self._raw.get(index)
        refit = x is not None and self.refit
        if x is not None:
            # the measured hidden statistics on the calibration maps
            hm = self._hidden_acts(src, x).float()
            n = hm.shape[0]
            mu = hm.mean(dim=0)
            G = (hm.T @ hm) / n
        if refit:
            # greedy selection on the objective the refit optimizes: the
            # centered output variance (the intercept absorbs a dropped mean)
            self._warn_rank(n, M)
            Kc = G - torch.outer(mu, mu)
            S, explained = _greedy_select(Kc.cpu().numpy(), (Kc @ W2).cpu().numpy(), k)
            total = float(torch.trace(W2.T @ (Kc @ W2)))
            # on a rank-deficient covariance the gains past its rank are noise
            kept_energy = min(explained / max(total, 1e-30), 1.0)
        else:
            # slicing keeps b2 as it is: dropping a channel costs its full second moment
            imp = (torch.diag(G) * (W2 ** 2).sum(dim=1) if x is not None
                   else self._weight_imp(src) ** 2)
            imp = imp.cpu().numpy()
            S = np.sort(np.argsort(-imp, kind="stable")[:k])  # k == M: the identity
            e = imp.astype(np.float64)
            kept_energy = float(e[S].sum() / max(e.sum(), 1e-30))
        idx = torch.as_tensor(S, device=W2.device)
        if refit:
            # augmented normal equations: [W2'; b2'] such that W2'^T h_S + b2'
            # matches W2^T h + b2 in L2 over the calibration set
            GS = G[idx][:, idx]
            muS = mu[idx]
            ridge = self.ridge * torch.trace(GS) / k
            A = torch.cat([torch.cat([GS + ridge * torch.eye(k, device=G.device), muS[:, None]], 1),
                           torch.cat([muS[None, :], G.new_ones(1, 1)], 1)], 0)
            Bm = torch.cat([G[idx] @ W2 + muS[:, None] * b2[None, :],
                            (mu @ W2 + b2)[None, :]], 0)
            X = torch.linalg.solve(A, Bm)
            W2p, b2p = X[:k], X[k]
            logger.info(f"keep {k}/{M} (contribution energy {kept_energy:.4f}), projection "
                        f"least-squares refit over {n} calib pixels")
        else:
            W2p, b2p = W2[idx], b2
            logger.info(f"keep {k}/{M} (contribution energy {kept_energy:.4f}), sliced"
                        + ("" if x is None else " (refit off)"))
        self._apply(src, tgt, idx, W2p, b2p)

    def _postprocess(self, sub: Substitution):
        pass

    # -- the FFN (conv-MLP) instance ------------------------------------------
    def _hidden_dim(self, mod) -> int:
        return mod.hidden_channel

    def _get_tgt_args(self, src: FFN) -> Dict:
        return dict(num_channel=src.num_channel, hidden_channel=self._k, drop=src.drop_rate)

    def _weight_imp(self, src: FFN) -> torch.Tensor:
        """Importance of hidden channel m from the weights alone: the product
        of the norms touching it (GELU is about 1-Lipschitz, so this bounds
        its contribution to the output)."""
        return (_norms(src.fc1.weight, (1, 2, 3)) * _norms(src.dconv.weight, (1, 2, 3))
                * _norms(src.fc2.weight, (0, 2, 3)))

    def _consumer(self, src: FFN):
        """The projection the refit rewrites, as (M, C) and (C,) float32."""
        w = src.fc2.weight[:, :, 0, 0].float()  # (C, M)
        b = src.fc2.bias.float() if src.fc2.bias is not None else w.new_zeros(w.shape[0])
        return w.T, b

    def _hidden_acts(self, src: FFN, x: torch.Tensor) -> torch.Tensor:
        """Post-GELU hidden activations on the tapped inputs, (n, M)."""
        return _flat_channels_last(gelu(src.dconv(src.fc1(x.float()))))

    def _apply(self, src: FFN, tgt: FFN, idx, W2p, b2p):
        """Slice the producers to the kept set; install the projection."""
        k, C = W2p.shape
        _take_into(tgt.fc1, src.fc1, idx)
        _take_into(tgt.dconv, src.dconv, idx)
        tgt.fc2.weight.copy_(W2p.T.reshape(C, k, 1, 1))
        tgt.fc2.bias.copy_(b2p)


@APP.register_module()
class MlpPrune(FfnPrune):
    """The ConvNeXt-block instance: prune the 4x Linear MLP's hidden width.

    The site is the whole block (the MLP has no module of its own); dwconv,
    norm and ``gamma`` are carried as they are, and the refit target is
    ``pwconv2``'s output (``gamma`` and the residual come after it)."""

    _src_type = ConvNeXtBlock
    _tgt_type = ConvNeXtBlock

    def _hidden_dim(self, mod) -> int:
        return mod.hidden

    def _get_tgt_args(self, src: ConvNeXtBlock) -> Dict:
        return dict(dim=src.dim, drop_path=src.drop_path.drop_prob,
                    layer_scale=src.gamma.init_value, hidden=self._k)

    def _fix_substitution(self, sub: Substitution, generator: torch.Generator):
        super()._fix_substitution(sub, generator)
        for name in ("dwconv", "norm", "gamma"):
            getattr(sub.new, name).load_state_dict(getattr(sub.old, name).state_dict())

    def _weight_imp(self, src: ConvNeXtBlock) -> torch.Tensor:
        return _norms(src.pwconv1.weight, 1) * _norms(src.pwconv2.weight, 0)

    def _consumer(self, src: ConvNeXtBlock):
        w = src.pwconv2.weight.float()  # (C, M)
        b = src.pwconv2.bias.float() if src.pwconv2.bias is not None else w.new_zeros(w.shape[0])
        return w.T, b

    def _hidden_acts(self, src: ConvNeXtBlock, x: torch.Tensor) -> torch.Tensor:
        h = src.dwconv(x.float()).permute(0, 2, 3, 1)  # NHWC
        h = src.act(src.pwconv1(src.norm(h)))
        return h.reshape(-1, h.shape[-1])

    def _apply(self, src: ConvNeXtBlock, tgt: ConvNeXtBlock, idx, W2p, b2p):
        _take_into(tgt.pwconv1, src.pwconv1, idx)
        tgt.pwconv2.weight.copy_(W2p.T)
        tgt.pwconv2.bias.copy_(b2p)


@APP.register_module()
class AttnPrune(FfnPrune):
    """The SpatialAttention instance: prune the gated MSCA branch's width.

    The gate ``h_m = attn_m * u_m`` ties the branch's input and output widths,
    so one mask slices ``proj_1``'s output, conv0, every strip conv,
    ``channel_mix`` (both axes) and ``proj_2``'s input.  This cuts the
    depthwise and elementwise work of MSCA, which scales with its width."""

    _src_type = SpatialAttention
    _tgt_type = SpatialAttention

    @torch.no_grad()
    def optimize(self, sub: Substitution):
        """With calibration: select on the full hidden, and refit on the hidden
        the pruned branch measures.

        Slicing ``channel_mix`` on both axes changes the kept channels'
        activations too (they lose the dropped rows' mixed-in parts), so the
        base class's refit in moment space would fit statistics the pruned
        network never produces.  Here the greedy set is chosen on the full
        gated hidden ``h``, the sliced branch is installed and run on the same
        maps (``h2``), and the projection is the ridge least-squares fit of
        ``[h2, 1] @ [W2'; b2']`` to the original output ``h @ W2 + b2``.
        """
        logger = get_logger()
        x = self._raw.get(self._opt_curr)
        if x is None or not self.refit:
            return super().optimize(sub)
        self._opt_curr += 1
        src, tgt = sub.old_module, sub.new_module
        M, k = self._hidden_dim(src), self._hidden_dim(tgt)
        W2, b2 = self._consumer(src)
        h = self._hidden_acts(src, x).float()
        n = h.shape[0]
        self._warn_rank(n, M)
        mu = h.mean(dim=0)
        Kc = (h.T @ h) / n - torch.outer(mu, mu)
        S, explained = _greedy_select(Kc.cpu().numpy(), (Kc @ W2).cpu().numpy(), k)
        total = float(torch.trace(W2.T @ (Kc @ W2)))
        kept = min(explained / max(total, 1e-30), 1.0)
        idx = torch.as_tensor(S, device=W2.device)
        # install the sliced branch (proj_2 sliced for now), then measure what
        # the pruned branch produces
        self._apply(src, tgt, idx, W2[idx], b2)
        h2 = self._hidden_acts(tgt, x).float()
        if n < 2 * (k + 1):
            logger.warning(f"AttnPrune: {n} calibration pixels for a {k + 1}-dim solve — "
                           f"refit skipped, sliced projection kept")
            return
        y = h @ W2 + b2[None, :]
        A = torch.cat([h2, h2.new_ones(n, 1)], dim=1)
        G2 = A.T @ A / n
        lam = self.ridge * torch.trace(G2[:k, :k]) / k
        reg = torch.diag(torch.cat([lam.reshape(1).expand(k), lam.new_zeros(1)]))
        X = torch.linalg.solve(G2 + reg, (A.T @ y) / n)
        tgt.proj_2.weight.copy_(X[:k].T.reshape(y.shape[1], k, 1, 1))
        tgt.proj_2.bias.copy_(X[k])
        logger.info(f"keep {k}/{M} (contribution energy {kept:.4f}), projection refit on the "
                    f"PRUNED branch's hidden over {n} calib pixels")

    def _hidden_dim(self, mod) -> int:
        return mod.inner_channel

    def _get_tgt_args(self, src: SpatialAttention) -> Dict:
        sgu = src.spatial_gating_unit
        return dict(num_channel=src.num_channel, k1_size=sgu.k1_size, k_sizes=sgu.k_sizes,
                    inner_channel=self._k)

    @staticmethod
    def _cascades(msca):
        return [b for b in msca.sd_convs.branches if isinstance(b, CascadeConv)]

    def _weight_imp(self, src: SpatialAttention) -> torch.Tensor:
        sgu = src.spatial_gating_unit
        n1 = _norms(src.proj_1.weight, (1, 2, 3))
        # the bank is a sum of per-channel cascades and the identity: branch
        # strengths add in quadrature, a cascade's two taps multiply
        bank_sq = torch.ones_like(n1)
        for c in self._cascades(sgu):
            bank_sq = bank_sq + (_norms(c.conv1.weight, (1, 2, 3))
                                 * _norms(c.conv2.weight, (1, 2, 3))) ** 2
        return (n1 * _norms(sgu.conv0.weight, (1, 2, 3)) * torch.sqrt(bank_sq)
                * _norms(sgu.channel_mix.weight, (1, 2, 3)) * _norms(src.proj_2.weight, (0, 2, 3)))

    def _consumer(self, src: SpatialAttention):
        w = src.proj_2.weight[:, :, 0, 0].float()
        b = src.proj_2.bias.float() if src.proj_2.bias is not None else w.new_zeros(w.shape[0])
        return w.T, b

    def _hidden_acts(self, src: SpatialAttention, x: torch.Tensor) -> torch.Tensor:
        return _flat_channels_last(src.spatial_gating_unit(gelu(src.proj_1(x.float()))))

    def _apply(self, src: SpatialAttention, tgt: SpatialAttention, idx, W2p, b2p):
        k, C = W2p.shape
        so, sn = src.spatial_gating_unit, tgt.spatial_gating_unit
        _take_into(tgt.proj_1, src.proj_1, idx)
        _take_into(sn.conv0, so.conv0, idx)
        for co, cn in zip(self._cascades(so), self._cascades(sn)):
            _take_into(cn.conv1, co.conv1, idx)
            _take_into(cn.conv2, co.conv2, idx)
        _take_into(sn.channel_mix, so.channel_mix, idx, square=True)
        tgt.proj_2.weight.copy_(W2p.T.reshape(C, k, 1, 1))
        tgt.proj_2.bias.copy_(b2p)

"""Serving rewrites of a model (port of ``convnet_approximater_tpu/deploy.py``).

* :func:`fold_batchnorm` folds eval-mode BatchNorm into the conv(s) that feed it;
* :func:`enable_pw_matmul` runs every pointwise conv as a matrix product over
  its NHWC view;
* :func:`quantize_int8` is int8 post-training quantization;
* :func:`prepare_qat` swaps dense convs and Linears for their fake-quant
  training twins, and :func:`convert_qat_to_int8` turns the trained twins into
  the int8 serving modules;
* :func:`prune_chains`, :func:`prune_trunks` and :func:`prune_width` prune
  channel widths across layers;
* :func:`rematerialize_dense` rebuilds the exact dense conv of a factored
  layer, and :func:`never_lose_deploy` serves each factored site in whichever
  form the timed model prefers;
* :func:`arbitrated_apply` applies an app only at the sites where the timed
  model gains, and replays a persisted decision table;
* :func:`compile_serving` captures the eval forward into a CUDA graph;
* :func:`export_serving` and :func:`load_serving` write and read the eval
  forward as a ``torch.export`` artifact, and :func:`pad_batch`,
  :func:`pad_batch_to_multiple` and :func:`chunk_batch` wrap a serving forward
  at the small and the large end of the batch sizes.

The names are the JAX package's, so a config's ``structure_passes`` find them.
"""

from __future__ import annotations

import copy
import io
import json
import os
import zlib
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from convnet_approximater_tpu_torch.layers.depth_separable_conv import CascadeConv, ParallelConv
from convnet_approximater_tpu_torch.layers.low_rank_conv import (LowRankExpConvV1,
                                                                 LowRankExpConvV2,
                                                                 LowRankExpConvV3,
                                                                 LowRankExpConvV4, SeparableConv)
from convnet_approximater_tpu_torch.layers.quant import (QATConv2d, QATLinear, QuantConv2d,
                                                         QuantLinear)
from convnet_approximater_tpu_torch.layers.substitution import Substitution
from convnet_approximater_tpu_torch.models.switchable import set_submodule
from convnet_approximater_tpu_torch.nn import (GELU, AdaptiveAvgPool2d, BatchNorm2d, Conv2d,
                                               Dropout, Identity, Linear, MaxPool2d, ReLU,
                                               channels_last, frozen_params_keys)
from convnet_approximater_tpu_torch.utils.dtype import cast_floating, dtype_of, serving_dtype
from convnet_approximater_tpu_torch.utils.logger import get_logger

# class name -> (conv, bn) attribute pairs of a module known to call the conv
# immediately before the bn (call order is not discoverable from structure):
# MSCAN's DownSample runs proj, then norm; every ResNet conv feeds its own BN
# (a downsample's pair is found as a Sequential's adjacent children).
FOLD_PATTERNS: Dict[str, List[Tuple[str, str]]] = {
    "DownSample": [("proj", "norm")],
    "ResNet": [("conv1", "bn1")],
    "BasicBlock": [("conv1", "bn1"), ("conv2", "bn2")],
    "Bottleneck": [("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3")],
}

# class name -> the child that produces the output of a composite layer ending
# in one linear conv, so that a BN folds through a factored site
FOLD_TAILS: Dict[str, str] = {
    "LowRankExpConvV1": "d_conv",  # grouped bases -> 1x1 mix (the bias carrier)
    "LowRankExpConvV2": "h_conv",  # vertical -> horizontal (the bias carrier)
    "LowRankExpConvV3": "mix_conv",  # dense k x k basis -> 1x1 mix
    "LowRankExpConvV4": "out_conv",  # Tucker-2: 1x1 -> k x k core -> 1x1
}


def _terminal_convs(model: nn.Module, path: str) -> Optional[List[str]]:
    """The dotted paths of the convs that produce the output of the module at
    ``path``, through ``FOLD_TAILS``, ``Sequential`` tails and both live
    branches of a ``Substitution`` (each feeds the same BN, so each absorbs
    the fold); None if any leaf is not a conv."""
    mod = model.get_submodule(path) if path else model
    if isinstance(mod, Conv2d):
        return [path]
    if isinstance(mod, Substitution):
        out = []
        for branch in ("old", "new"):
            if branch in mod._modules:
                sub = _terminal_convs(model, f"{path}.{branch}")
                if sub is None:
                    return None
                out.extend(sub)
        return out or None
    tail = FOLD_TAILS.get(type(mod).__name__)
    if tail is not None and tail in mod._modules:
        return _terminal_convs(model, f"{path}.{tail}")
    if isinstance(mod, nn.Sequential) and len(mod):
        return _terminal_convs(model, f"{path}.{list(mod._modules)[-1]}")
    return None


@torch.no_grad()
def _fold_pair(conv: Conv2d, bn: BatchNorm2d):
    """Fold ``bn``'s affine and running stats into ``conv`` in place, in float32,
    cast back to the weight's type; a conv without a bias gains one on its
    weight's device."""
    w = conv.weight
    r = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)  # (C_out,)
    b0 = conv.bias.float() if conv.bias is not None else torch.zeros_like(r)
    new_b = ((b0 - bn.running_mean.float()) * r + bn.bias.float()).to(w.dtype)
    w.copy_((w.float() * r[:, None, None, None]).to(w.dtype))
    if conv.bias is None:
        conv.bias = nn.Parameter(new_b.to(w.device))
    else:
        conv.bias.copy_(new_b)


def fold_batchnorm(model: nn.Module) -> int:
    """Fold every discoverable conv -> BatchNorm pair in place; returns the count.

    Sites are adjacent ``(module, BatchNorm2d)`` children of a ``Sequential``
    and the attribute pairs of ``FOLD_PATTERNS`` (walking the class's MRO);
    the module side resolves to its terminal convs (:func:`_terminal_convs`).
    Each folded BN becomes ``Identity``, so its ``state_dict`` keys go.  The
    fold freezes the running stats into the weights: it is exact for the
    eval-mode forward only.  A BN that feeds nothing foldable, and a block's
    pre-norm (MSCAN's ``norm1``/``norm2``), stays.
    """
    pairs: List[Tuple[str, str]] = []  # (site, bn) dotted paths
    for path, mod in model.named_modules():
        def sub(name):
            return f"{path}.{name}" if path else name

        if isinstance(mod, nn.Sequential):
            names = list(mod._modules)
            for a, b in zip(names, names[1:]):
                if isinstance(mod._modules[b], BatchNorm2d):
                    pairs.append((sub(a), sub(b)))
        for klass in type(mod).__mro__:
            for conv_attr, bn_attr in FOLD_PATTERNS.get(klass.__name__, ()):
                if conv_attr in mod._modules and isinstance(mod._modules.get(bn_attr),
                                                            BatchNorm2d):
                    pairs.append((sub(conv_attr), sub(bn_attr)))

    n_folded = 0
    for site, bn_path in pairs:
        bn = model.get_submodule(bn_path)
        conv_paths = _terminal_convs(model, site)
        if not isinstance(bn, BatchNorm2d) or conv_paths is None:
            continue  # folded already, or the site does not end in convs
        convs = [model.get_submodule(p) for p in conv_paths]
        if any(c.out_channels != bn.num_features for c in convs):
            continue
        for conv in convs:
            _fold_pair(conv, bn)
        set_submodule(model, bn_path, Identity())
        n_folded += 1
    return n_folded


def enable_pw_matmul(model: nn.Module) -> int:
    """Set ``pw_matmul`` on every pointwise conv (1x1, ``groups == 1``, stride 1,
    no padding, no dilation) that does not have it yet; returns how many.

    Each then runs as a matrix product over its input's NHWC view in eval mode
    (:class:`~convnet_approximater_tpu_torch.nn.Conv2d`).  Only a flag changes,
    no parameter, so the rewrite is idempotent and keeps the ``state_dict``.
    """
    n = 0
    for mod in model.modules():
        if isinstance(mod, Conv2d) and mod.is_pointwise() and not mod.pw_matmul:
            mod.pw_matmul = True
            n += 1
    return n


def quantize_int8(model: nn.Module, calib_batches: Iterable[torch.Tensor],
                  filter_fn: Optional[Callable[[str, nn.Module], bool]] = None,
                  linears: bool = True) -> int:
    """int8 post-training quantization of every dense conv, and of every
    ``Linear`` when ``linears``, for serving.  Returns the number of modules
    quantized.

    1. Calibrate: run the model in eval mode over ``calib_batches`` and take
       the largest absolute input value of each target.
    2. Rewrite: swap each target for a ``QuantConv2d`` / ``QuantLinear`` with
       per-channel int8 weights and the static input scale
       ``max(absmax, 1e-12) / 127``.

    Targets are exact types only (``type(m) is Conv2d`` with ``groups == 1``,
    or ``type(m) is Linear``): a subclass with its own forward would lose it,
    and depthwise strips stay as they are.  ``filter_fn(path, module)``
    narrows the set further.  A target that a kernel layer computes in place of
    its module (``MSCA``'s ``channel_mix`` inside ``msca_fused``) is observed
    in a second pass on the module path (autograd on); once quantized, that
    layer takes its module path.
    """
    targets = [(path, m) for path, m in model.named_modules()
               if ((type(m) is Conv2d and m.groups == 1) or (linears and type(m) is Linear))
               and (filter_fn is None or filter_fn(path, m))]
    if not targets:
        return 0

    # -- calibrate ---------------------------------------------------------
    absmax: Dict[str, torch.Tensor] = {}

    def observe(path):
        def hook(module, inputs):
            cur = inputs[0].detach().abs().amax().float()
            absmax[path] = cur if path not in absmax else torch.maximum(absmax[path], cur)
        return hook

    def calibrate(observed, grad: bool):
        handles = [m.register_forward_pre_hook(observe(path)) for path, m in observed]
        try:
            with torch.set_grad_enabled(grad):
                for x in calib_batches:
                    model(x)
        finally:
            for h in handles:
                h.remove()

    model.eval()
    calib_batches = list(calib_batches)
    if not calib_batches:
        raise ValueError("quantize_int8 needs at least one calibration batch")
    calibrate(targets, grad=False)
    unseen = [(path, m) for path, m in targets if path not in absmax]
    if unseen:  # computed by a kernel layer: observe them on its module path
        calibrate(unseen, grad=True)
    missing = [path for path, _ in targets if path not in absmax]
    if missing:
        raise RuntimeError(f"calibration never reached {missing}")

    # -- rewrite -----------------------------------------------------------
    for path, m in targets:
        act_scale = max(float(absmax[path]), 1e-12) / 127.0
        q = (QuantConv2d.from_conv(m, act_scale) if isinstance(m, Conv2d)
             else QuantLinear.from_linear(m, act_scale))
        set_submodule(model, path, q)
    return len(targets)


def qat_substitution_filter(model: nn.Module) -> Callable[[str, nn.Module], bool]:
    """A ``filter_fn`` that leaves out every module inside a ``Substitution``:
    QAT covers the dense remainder while the substitutions cover their own
    sites."""
    prefixes = tuple(path + "." for path, mod in model.named_modules()
                     if isinstance(mod, Substitution))

    def filter_fn(path, mod):
        return not path.startswith(prefixes) if prefixes else True

    return filter_fn


def prepare_qat(model: nn.Module, filter_fn: Optional[Callable[[str, nn.Module], bool]] = None,
                linears: bool = True, momentum: float = 0.1, verbose: bool = False) -> int:
    """Swap every dense conv (``type(m) is Conv2d`` with ``groups == 1``), and
    every ``Linear`` when ``linears``, that ``filter_fn(path, module)`` keeps,
    for its fake-quant twin (:class:`QATConv2d` / :class:`QATLinear`), in place,
    so that a fine-tune trains the weights under int8 numerics.  The twins hold
    the same parameter tensors under the same names and add one ``act_absmax``
    observer buffer each, at 0 until a training batch.  Call it after
    :func:`fold_batchnorm` if the served form folds BN.  Returns the number of
    modules swapped."""
    n = 0
    for path, mod in list(model.named_modules()):
        ok = (type(mod) is Conv2d and mod.groups == 1) or (linears and type(mod) is Linear)
        if not ok or (filter_fn is not None and not filter_fn(path, mod)):
            continue
        qat = (QATConv2d.from_conv(mod, qat_momentum=momentum) if isinstance(mod, Conv2d)
               else QATLinear.from_linear(mod, qat_momentum=momentum))
        set_submodule(model, path, qat)
        n += 1
        if verbose:
            print(f"prepare_qat: {path}")
    return n


def convert_qat_to_int8(model: nn.Module, verbose: bool = False) -> int:
    """Turn every :class:`QATConv2d` / :class:`QATLinear` of a QAT-trained model
    into a :class:`QuantConv2d` / :class:`QuantLinear` whose input scale is its
    learned observer, ``act_absmax / 127``: the PTQ modules of
    :func:`quantize_int8`, with the same weight grid.  Raises when an observer is
    missing or never saw a training batch.  Returns the number converted."""
    n = 0
    for path, mod in list(model.named_modules()):
        if not isinstance(mod, (QATConv2d, QATLinear)):
            continue
        if mod._buffers.get("act_absmax") is None:
            raise RuntimeError(
                f"convert_qat_to_int8: no observer state for {path} — was the model "
                f"fine-tuned (training=True) after prepare_qat?")
        absmax = float(mod.act_absmax)
        if absmax <= 0:
            raise RuntimeError(f"convert_qat_to_int8: observer at {path} never saw a "
                               f"training batch (act_absmax=0)")
        act_scale = absmax / 127.0
        q = (QuantConv2d.from_conv(mod, act_scale) if isinstance(mod, QATConv2d)
             else QuantLinear.from_linear(mod, act_scale))
        set_submodule(model, path, q)
        n += 1
        if verbose:
            print(f"convert_qat_to_int8: {path} (act_scale={act_scale:.3e})")
    return n


# class name -> (producer, (bns...), consumer) attribute junctions whose width is
# free to prune: a residual block pins its input and output width, not its
# internal one
PRUNE_PATTERNS: Dict[str, List[Tuple[str, Tuple[str, ...], str]]] = {
    "BasicBlock": [("conv1", ("bn1",), "conv2")],
    "Bottleneck": [("conv1", ("bn1",), "conv2"), ("conv2", ("bn2",), "conv3")],
}

# layers a channel passes through unchanged between a producer and its consumer
# (LayerNorm and GroupNorm couple channels through their statistics: they end a chain)
_PASSTHROUGH = (ReLU, GELU, Dropout, MaxPool2d, AdaptiveAvgPool2d)


def _prune_round(k: int, M: int, round_to) -> int:
    """``k`` snapped to a multiple of ``round_to`` in [round_to, M] (Python's
    round: half to even), or clipped to [1, M] when ``M <= round_to``."""
    if not round_to or M <= round_to:
        return max(1, min(k, M))
    return min(M, max(round_to, int(round(k / round_to)) * round_to))


def _is_dense(m: nn.Module) -> bool:
    return (isinstance(m, nn.Conv2d) and m.groups == 1) or isinstance(m, nn.Linear)


def _width_out(m: nn.Module) -> int:
    return m.out_channels if isinstance(m, nn.Conv2d) else m.out_features


def _take(t: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """``t`` at ``idx`` along ``dim``: a new tensor, ``channels_last`` if ``t`` is."""
    out = t.detach().index_select(dim, idx.to(t.device))
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        out = out.contiguous(memory_format=torch.channels_last)
    return out


def _slice(mod: nn.Module, name: str, dim: int, idx: torch.Tensor):
    """Replace ``mod.<name>`` (a parameter or a buffer) by its slice at ``idx``:
    a new tensor, so that every cache keyed on the old one is built again."""
    t = getattr(mod, name)
    if t is None:
        return
    if isinstance(t, nn.Parameter):
        setattr(mod, name, nn.Parameter(_take(t, dim, idx), requires_grad=t.requires_grad))
    else:
        setattr(mod, name, _take(t, dim, idx))


def _slice_out(mod: nn.Module, idx: torch.Tensor):
    """Keep the output channels ``idx`` of a conv or a Linear."""
    _slice(mod, "weight", 0, idx)
    _slice(mod, "bias", 0, idx)
    if isinstance(mod, nn.Conv2d):
        mod.out_channels = len(idx)
    else:
        mod.out_features = len(idx)


def _slice_in(mod: nn.Module, idx: torch.Tensor, width: int):
    """Keep the input channels ``idx`` of a dense conv or a Linear."""
    _slice(mod, "weight", 1, idx)
    if isinstance(mod, nn.Conv2d):
        mod.in_channels = width
    else:
        mod.in_features = width


def _slice_norm(mod: nn.Module, idx: torch.Tensor):
    """Keep the channels ``idx`` of a BatchNorm2d (with its running stats) or a
    LayerNorm; anything else (a folded BN's Identity) is left alone."""
    if isinstance(mod, BatchNorm2d):
        for name in ("weight", "bias", "running_mean", "running_var"):
            _slice(mod, name, 0, idx)
        mod.num_features = len(idx)
    elif isinstance(mod, nn.LayerNorm):
        _slice(mod, "weight", 0, idx)
        _slice(mod, "bias", 0, idx)
        mod.normalized_shape = (len(idx),)


def _bn_gain(bn: nn.Module) -> Optional[torch.Tensor]:
    """The gain a BatchNorm2d applies per channel, ``|scale| / sqrt(var + eps)``;
    None for anything else."""
    if not isinstance(bn, BatchNorm2d):
        return None
    return bn.weight.detach().float().abs() * torch.rsqrt(bn.running_var.float() + bn.eps)


def _patch_moments(x: torch.Tensor, kh: int, kw: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uncentered second moment and mean of the unpadded stride-1 (kh, kw)
    patches of ``x`` (B, C, H, W): ((D, D), (D,)) with the flat index
    ``c*kh*kw + u*kw + v``, the order an OIHW kernel flattens to; zeros on a
    map smaller than the kernel (its sample count is 0, so no refit reads them)."""
    x = x.float()
    D = x.shape[1] * kh * kw
    if x.shape[2] < kh or x.shape[3] < kw:  # no window: no statistic
        return x.new_zeros(D, D), x.new_zeros(D)
    G, s, n = 0, 0, 0
    for b in range(x.shape[0]):
        cols = F.unfold(x[b:b + 1], (kh, kw))[0]  # (D, L)
        G = G + cols @ cols.T
        s = s + cols.sum(dim=1)
        n += cols.shape[1]
    return G / n, s / n


def _junctions(model: nn.Module) -> List[Tuple[str, Tuple[str, ...], str]]:
    """``(producer, (bns...), consumer)`` paths of every prunable junction:
    adjacent dense layers of a ``Sequential`` with only channel-preserving
    layers and BatchNorms between them, and the ``PRUNE_PATTERNS`` pairs."""
    junctions = []
    for path, mod in list(model.named_modules()):
        def sub(name):
            return f"{path}.{name}" if path else name

        if isinstance(mod, nn.Sequential):
            names = list(mod._modules)
            i = 0
            while i < len(names):
                a = mod._modules[names[i]]
                if not _is_dense(a):
                    i += 1
                    continue
                bns, j = [], i + 1
                while j < len(names):
                    m = mod._modules[names[j]]
                    if isinstance(m, BatchNorm2d):
                        bns.append(names[j])
                    elif not isinstance(m, _PASSTHROUGH):
                        break
                    j += 1
                nxt = mod._modules[names[j]] if j < len(names) else None
                # a Flatten (or anything else) between a conv and a Linear
                # breaks the channel identity
                if nxt is not None and _is_dense(nxt) \
                        and isinstance(a, nn.Conv2d) == isinstance(nxt, nn.Conv2d):
                    junctions.append((sub(names[i]), tuple(sub(b) for b in bns),
                                      sub(names[j])))
                i = j  # the consumer is the next candidate producer
        for klass in type(mod).__mro__:
            for pa, bns, ca in PRUNE_PATTERNS.get(klass.__name__, ()):
                kids = mod._modules
                if _is_dense(kids.get(pa)) and _is_dense(kids.get(ca)) \
                        and all(isinstance(kids.get(b), BatchNorm2d) for b in bns):
                    junctions.append((sub(pa), tuple(sub(b) for b in bns), sub(ca)))
    return junctions


def _consumer(model: nn.Module, c) -> Tuple[nn.Module, Optional[int]]:
    """``(module, offset)`` of a consumer entry: a path, or a dict
    ``{"path", "offset_modules"}`` for a consumer that reads the trunk as one
    segment of a channel-concatenated input (SegNeXt's squeeze conv), whose
    offset is the sum of the current widths of the listed norms (None for a path)."""
    if not isinstance(c, dict):
        return model.get_submodule(c), None
    off = 0
    for p in c.get("offset_modules", ()):
        norm = model.get_submodule(p)
        off += norm.normalized_shape[0] if isinstance(norm, nn.LayerNorm) else norm.num_features
    return model.get_submodule(c["path"]), off


@torch.no_grad()
def _consumer_stats(model: nn.Module, consumers: Sequence[str],
                    calib_batches: Iterable[torch.Tensor]) -> Dict[str, dict]:
    """The input statistics of each consumer on the calibration batches, each
    the mean over the batches of one batch's: the (patch) second moment ``G``
    and mean ``mu``, the per-channel mean and mean square, and the sample count
    ``n``.  A conv whose patch Gram would pass 8192 rows, or that is dilated,
    gets none (its junction falls back to the weights)."""
    stats: Dict[str, dict] = {}
    counts: Dict[str, int] = {}

    def tap(path):
        mod = model.get_submodule(path)

        def hook(module, inputs):
            x = inputs[0].detach().float()
            if isinstance(mod, nn.Conv2d):
                kh, kw = mod.kernel_size
                if x.shape[1] * kh * kw > 8192 or mod.dilation != (1, 1):
                    return
                G, mu = _patch_moments(x, kh, kw)
                n = x.shape[0] * (x.shape[2] - kh + 1) * (x.shape[3] - kw + 1)
                flat = x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])
            else:
                flat = x.reshape(-1, x.shape[-1])
                G, mu, n = flat.T @ flat / flat.shape[0], flat.mean(dim=0), flat.shape[0]
            st = stats.setdefault(path, dict(G=0, mu=0, ch_mu=0, ch_sq=0, n=0))
            st["G"] = st["G"] + G
            st["mu"] = st["mu"] + mu
            st["ch_mu"] = st["ch_mu"] + flat.mean(dim=0)
            st["ch_sq"] = st["ch_sq"] + (flat ** 2).mean(dim=0)
            st["n"] += n
            counts[path] = counts.get(path, 0) + 1
        return hook

    was_training = model.training
    model.eval()
    handles = [model.get_submodule(c).register_forward_pre_hook(tap(c)) for c in consumers]
    try:
        for x in calib_batches:
            model(x)
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    for c, st in stats.items():
        for key in ("G", "mu", "ch_mu", "ch_sq"):
            st[key] = st[key] / counts[c]
    return stats


@torch.no_grad()
def _refit_consumer(cons: nn.Module, S: np.ndarray, st: dict, ridge: float):
    """Refit ``cons`` over its kept input channels ``S`` in closed form: least
    squares on the (patch) Gram with an intercept row that takes the dropped
    channels' means into the bias."""
    wb = cons.weight.detach().float()
    conv = isinstance(cons, nn.Conv2d)
    O = wb.shape[0]
    if conv:
        kh, kw = cons.kernel_size
        Wf = wb.reshape(O, -1).T  # rows in (c, u, v) order
        Sp = (S[:, None] * (kh * kw) + np.arange(kh * kw)[None, :]).reshape(-1)
    else:
        Wf, Sp = wb.T, S
    G, mu = st["G"], st["mu"]
    idx = torch.as_tensor(Sp, device=G.device)
    b0 = cons.bias.detach().float() if cons.bias is not None else wb.new_zeros(O)
    GS, muS = G[idx][:, idx], mu[idx]
    d = len(Sp)
    lam = ridge * torch.trace(GS) / d
    A = torch.cat([torch.cat([GS + lam * torch.eye(d, device=G.device), muS[:, None]], 1),
                   torch.cat([muS[None, :], G.new_ones(1, 1)], 1)], 0)
    Bm = torch.cat([G[idx] @ Wf + muS[:, None] * b0[None, :], (mu @ Wf + b0)[None, :]], 0)
    X = torch.linalg.solve(A, Bm)
    Wp = X[:-1].T
    if conv:
        Wp = Wp.reshape(O, len(S), kh, kw)
        if cons.weight.is_contiguous(memory_format=torch.channels_last):
            Wp = Wp.contiguous(memory_format=torch.channels_last)
    dt = cons.weight.dtype
    cons.weight = nn.Parameter(Wp.to(dt), requires_grad=cons.weight.requires_grad)
    cons.bias = nn.Parameter(X[-1].to(dt), requires_grad=cons.weight.requires_grad)
    if conv:
        cons.in_channels = len(S)
    else:
        cons.in_features = len(S)


@torch.no_grad()
def prune_chains(model: nn.Module, keep_ratio: float, round_to: int = 128,
                 calib_batches: Optional[Iterable[torch.Tensor]] = None, ridge: float = 1e-6,
                 dry_run: bool = False) -> int:
    """Structured channel pruning of producer -> consumer junctions, in place;
    returns the number of junctions pruned.

    The junctions are adjacent dense convs or Linears of a ``Sequential`` with
    only per-channel layers between them (ReLU, GELU, Dropout, the pools, and
    BatchNorm2d, sliced with the junction), and the ``PRUNE_PATTERNS`` of
    residual blocks.  Each keeps ``round(M * keep_ratio)`` of its ``M``
    channels, snapped to ``round_to`` (a junction whose snapped width is M is
    skipped): the producer's outputs, the BNs and the consumer's inputs
    shrink together, as new parameters.  The channels kept are those of
    largest ``||W_a[m]|| * g_m * ||W_b[:, m]||`` (``g`` the BN gain).  With
    ``calib_batches`` each consumer's input is tapped on the batches (a forward
    pre-hook, removed after), channels rank by ``Var[x_m] * ||W_b[:, m]||^2``
    and the consumer is refit in closed form over the kept channels (least
    squares on the patch Gram, the dropped channels' means into a bias), unless
    it saw fewer than twice as many samples as unknowns.  ``dry_run`` counts
    the junctions it would prune and edits nothing.
    """
    logger = get_logger()
    junctions = _junctions(model)
    stats: Dict[str, dict] = {}
    if calib_batches is not None and not dry_run and junctions:
        stats = _consumer_stats(model, sorted({c for _, _, c in junctions}), calib_batches)

    n_pruned = 0
    for prod_path, bn_paths, cons_path in junctions:
        prod = model.get_submodule(prod_path)
        cons = model.get_submodule(cons_path)
        conv = isinstance(prod, nn.Conv2d)
        M = _width_out(prod)
        k = _prune_round(int(round(M * keep_ratio)), M, round_to)
        if k >= M:
            logger.info(f"prune_chains: {prod_path} keep {k}/{M} (snapped) — skipped")
            continue
        if dry_run:
            n_pruned += 1
            continue
        nb = torch.sqrt((cons.weight.detach().float() ** 2).sum(dim=(0, 2, 3) if conv else 0))
        st = stats.get(cons_path)
        if st is not None:
            # the tapped input already carries the producer, BN and activation
            var_c = torch.clamp(st["ch_sq"] - st["ch_mu"] ** 2, min=0.0)
            imp = (var_c * nb ** 2).cpu().numpy()
        else:
            na = torch.sqrt((prod.weight.detach().float() ** 2).sum(dim=(1, 2, 3) if conv else 1))
            g = torch.ones_like(na)
            for bp in bn_paths:
                g = g * _bn_gain(model.get_submodule(bp))
            imp = (na * g * nb).cpu().numpy()
        S = np.sort(np.argsort(-imp, kind="stable")[:k])
        idx = torch.as_tensor(S)
        _slice_out(prod, idx)
        for bp in bn_paths:
            _slice_norm(model.get_submodule(bp), idx)
        unknowns = k * (int(np.prod(cons.kernel_size)) if conv else 1)
        if st is not None and st["n"] < 2 * unknowns:
            # fewer samples than twice the unknowns: the refit would fit noise
            logger.warning(
                f"prune_chains: {cons_path} refit skipped — only {st['n']} calibration "
                f"patches for a {unknowns}-dim solve; add calibration batches (>=2x that "
                f"many patches); sliced instead")
            st = None
        if st is not None:
            _refit_consumer(cons, S, st, ridge)
        else:
            _slice_in(cons, idx, k)
        n_pruned += 1
        e = imp.astype(np.float64) ** 2
        logger.info(f"prune_chains: {prod_path} -> {cons_path}: keep {k}/{M} "
                    f"(importance energy {e[S].sum() / max(e.sum(), 1e-30):.4f})")
    if n_pruned and not dry_run:
        logger.info(f"prune_chains: {n_pruned} junctions pruned (keep_ratio {keep_ratio}, "
                    f"round_to {round_to})")
    return n_pruned


def _trunk_groups(model: nn.Module) -> List[dict]:
    """Residual-trunk channel groups: producers whose outputs meet on one
    tensor through identity adds, and every consumer of that tensor.

    A model may define ``trunk_groups()`` (MSCAN and ConvNeXt do: their trunks
    also thread norms, layer-scale vectors, depthwise convs and width
    attributes); otherwise the walk covers torchvision-style residual models
    (a ``conv1``/``bn1`` stem, stage ``Sequential``s of blocks with ``conv1``,
    ``downsample`` and a last ``conv2``/``conv3``, an optional ``fc``)."""
    hook = getattr(model, "trunk_groups", None)
    groups = hook() if callable(hook) else _residual_trunks(model)
    for g in groups:
        for key in ("norms", "vectors", "depthwise", "attrs"):
            g.setdefault(key, [])
    return [g for g in groups if g["producers"] and g["consumers"]]


def _residual_trunks(model: nn.Module) -> List[dict]:
    """The trunk groups of a torchvision-style residual model."""

    def conv_at(m, name):
        return isinstance(getattr(m, name, None), nn.Conv2d)

    def is_block(m):
        return conv_at(m, "conv1") and hasattr(m, "downsample") \
            and (conv_at(m, "conv3") or conv_at(m, "conv2"))

    groups: List[dict] = []
    cur = None
    if conv_at(model, "conv1") and isinstance(getattr(model, "bn1", None), BatchNorm2d):
        cur = {"producers": [("conv1", "bn1")], "consumers": []}
    for lname, layer in model.named_children():
        if not isinstance(layer, nn.Sequential):
            continue
        blocks = list(layer.named_children())
        if not blocks or not all(is_block(b) for _, b in blocks):
            # a plain conv stack may change the width: the open group ends here
            cur = None
            continue
        for bname, block in blocks:
            bp = f"{lname}.{bname}"
            last = "conv3" if conv_at(block, "conv3") else "conv2"
            lastbn = "bn3" if last == "conv3" else "bn2"
            lastbn = f"{bp}.{lastbn}" if isinstance(getattr(block, lastbn, None),
                                                     BatchNorm2d) else None
            if block.downsample is not None:
                # a projection shortcut: the incoming trunk ends here
                if cur is not None:
                    cur["consumers"] += [f"{bp}.conv1", f"{bp}.downsample.0"]
                    groups.append(cur)
                ds_bn = isinstance(block.downsample._modules.get("1"), BatchNorm2d)
                cur = {"producers": [(f"{bp}.downsample.0",
                                      f"{bp}.downsample.1" if ds_bn else None),
                                     (f"{bp}.{last}", lastbn)],
                       "consumers": []}
            else:
                # an identity shortcut: the block reads and writes the same trunk
                if cur is None:
                    cur = {"producers": [], "consumers": []}
                cur["consumers"].append(f"{bp}.conv1")
                cur["producers"].append((f"{bp}.{last}", lastbn))
    if cur is not None:
        fc = getattr(model, "fc", None)
        if isinstance(fc, nn.Linear) and cur["producers"] and fc.in_features == \
                model.get_submodule(cur["producers"][0][0]).out_channels:
            cur["consumers"].append("fc")
        if cur["consumers"]:
            groups.append(cur)
    return groups


def _vector_parent(model: nn.Module, path: str) -> Tuple[nn.Module, str]:
    parent, _, name = path.rpartition(".")
    return (model.get_submodule(parent) if parent else model), name


@torch.no_grad()
def prune_trunks(model: nn.Module, keep_ratio: float, round_to: int = 64,
                 dry_run: bool = False) -> int:
    """Residual-trunk structured channel pruning with one shared mask per trunk,
    in place; returns the number of trunk groups pruned.

    An identity add pins every block's input and output to the stage's trunk
    width, so no single junction can cut it; this pass slices one mask through
    all that touches the trunk (:func:`_trunk_groups`): every producer (and
    its BN), every consumer's input (or its segment of a concatenated input:
    :func:`_consumer`), the depthwise convs, norms and
    layer-scale vectors riding on it, and the width attributes later passes
    build from.  The channels kept are those of largest
    ``sqrt(sum_p ||W_p[m]||^2 g_m^2) * sqrt(sum_c ||W_c[:, m]||^2)`` over the
    producers p (``g`` the BN gain) and consumers c, times the RMS of the
    group's layer-scale vectors.  ``round_to`` snaps the kept width; a group
    whose snapped width is its full width is skipped.  ``dry_run`` counts
    without editing.
    """
    logger = get_logger()
    n_pruned = 0
    for gi, g in enumerate(_trunk_groups(model)):
        prods = [(model.get_submodule(p), bn) for p, bn in g["producers"]]
        cons = [_consumer(model, c) for c in g["consumers"]]
        M = _width_out(prods[0][0])
        if any(_width_out(p) != M for p, _ in prods):
            continue  # a malformed group: leave it alone
        k = _prune_round(int(round(M * keep_ratio)), M, round_to)
        if k >= M:
            logger.info(f"prune_trunks: group {gi} keep {k}/{M} (snapped) — skipped")
            continue
        if dry_run:
            n_pruned += 1
            continue

        prod_e = 0
        for mod, bn_path in prods:
            na = (mod.weight.detach().float() ** 2).sum(
                dim=(1, 2, 3) if isinstance(mod, nn.Conv2d) else 1)
            gain = _bn_gain(model.get_submodule(bn_path)) if bn_path is not None else None
            prod_e = prod_e + (na if gain is None else na * gain ** 2)
        cons_e = 0
        for mod, off in cons:
            w = mod.weight.detach().float()
            if off is not None:  # the trunk's segment of the consumer's input
                w = w[:, off:off + M]
            cons_e = cons_e + (w ** 2).sum(dim=(0, 2, 3) if isinstance(mod, nn.Conv2d) else 0)
        # layer-scale vectors gate the producers: their RMS over the group (a
        # product of many 1e-2 scales would underflow)
        vecs = [getattr(*_vector_parent(model, vp)) for vp in g["vectors"]]
        vec_gain = (torch.sqrt(sum(v.detach().float() ** 2 for v in vecs) / len(vecs))
                    if vecs else 1.0)
        imp = (torch.sqrt(prod_e) * torch.sqrt(cons_e) * vec_gain).cpu().numpy()
        S = np.sort(np.argsort(-imp, kind="stable")[:k])
        idx = torch.as_tensor(S)

        for mod, bn_path in prods:
            _slice_out(mod, idx)
            if bn_path is not None:
                _slice_norm(model.get_submodule(bn_path), idx)
        for mod, off in cons:
            if off is None:
                _slice_in(mod, idx, k)
            else:  # keep the other segments whole
                total = mod.weight.shape[1]
                _slice_in(mod, torch.cat([torch.arange(off), idx + off,
                                          torch.arange(off + M, total)]), total - (M - k))
        for dpath in g["depthwise"]:
            # a channel-tied pass-through (ConvNeXt's 7x7 on the trunk)
            dm = model.get_submodule(dpath)
            _slice(dm, "weight", 0, idx)
            _slice(dm, "bias", 0, idx)
            dm.in_channels = dm.out_channels = dm.groups = k
        for npath in g["norms"]:
            _slice_norm(model.get_submodule(npath), idx)
        for vp in g["vectors"]:
            _slice(*_vector_parent(model, vp), 0, idx)
        for apath, aname in g["attrs"]:
            setattr(model.get_submodule(apath) if apath else model, aname, k)
        n_pruned += 1
        e = imp.astype(np.float64) ** 2
        logger.info(f"prune_trunks: group {gi} ({len(prods)} producers, {len(cons)} consumers): "
                    f"keep {k}/{M} (importance energy {e[S].sum() / max(e.sum(), 1e-30):.4f})")
    if n_pruned and not dry_run:
        logger.info(f"prune_trunks: {n_pruned} trunk groups pruned (keep_ratio {keep_ratio}, "
                    f"round_to {round_to})")
    return n_pruned


def prune_width(model: nn.Module, keep_ratio: float, round_to: int = 64,
                ffn_round_to: int = 128, dry_run: bool = False) -> int:
    """Every width axis of the model in one pass, in dependency order:
    :func:`prune_trunks`, :func:`prune_chains`, then on a switchable model the
    width apps ``AttnPrune``, ``FfnPrune`` and ``MlpPrune`` (weight-ranked: a
    structure pass has no calibration stream), each a no-op where the model
    has no such axis.  The model's switchable registration is restored after
    the app loop.  Returns the sites and groups pruned in all."""
    n = prune_trunks(model, keep_ratio, round_to=round_to, dry_run=dry_run)
    n += prune_chains(model, keep_ratio, round_to=round_to, dry_run=dry_run)
    if not hasattr(model, "register_switchable"):
        return n
    from convnet_approximater_tpu_torch.core import AttnPrune, FfnPrune, MlpPrune
    from convnet_approximater_tpu_torch.deploy_planner import apply_app

    saved = list(model._switchable_names)
    try:
        for app in (AttnPrune(keep_ratio=keep_ratio),
                    FfnPrune(keep_ratio=keep_ratio, round_to=ffn_round_to),
                    MlpPrune(keep_ratio=keep_ratio, round_to=ffn_round_to)):
            if dry_run:
                model.register_switchable(app.src_type, [])
                n += model.length_switchable
            else:
                n += apply_app(model, app, [])
    finally:
        model._switchable_names = saved
    return n


def _dense_conv(like: nn.Module, weight: torch.Tensor, bias: Optional[torch.Tensor],
                stride, padding, groups: int = 1) -> Conv2d:
    """A ``Conv2d`` holding the float32 OIHW ``weight`` (and ``bias``) cast back
    to the type of ``like``'s parameters, on their device, in ``channels_last``
    and ``like``'s training mode."""
    ref = next(like.parameters())
    N, Cg, kh, kw = weight.shape
    conv = Conv2d(Cg * groups, N, (kh, kw), stride=stride, padding=padding, groups=groups,
                  bias=bias is not None)
    with torch.no_grad():
        conv.weight = nn.Parameter(weight.to(ref.dtype), requires_grad=ref.requires_grad)
        if bias is not None:
            conv.bias = nn.Parameter(bias.detach().to(ref.dtype).clone(),
                                     requires_grad=ref.requires_grad)
    return channels_last(conv.to(ref.device)).train(like.training)


@torch.no_grad()
def rematerialize_dense(module: nn.Module) -> Optional[Conv2d]:
    """The exact dense ``Conv2d`` of a factored layer, or None.

    The factored layers are linear, so the kernel they compute rebuilds
    exactly (OIHW, in float32, cast back to the stored type):

    * ``LowRankExpConvV1``, grouped ``s_conv`` (C*M, 1, kh, kw) and 1x1
      ``d_conv`` (N, C*M): ``W[n, c] = sum_m s[c*M + m] d[n, c*M + m]``; in its
      decomposed form the rank-1 ``v (x) h`` of each basis stands for ``s``;
    * ``LowRankExpConvV2`` (vertical C -> M, horizontal M -> N):
      ``W[n, c, u, v] = sum_m V[m, c, u] H[n, m, v]``; None when ``grouped``
      (it has no dense N-output equivalent);
    * ``LowRankExpConvV3`` and ``V4``: the product of their convs' weights;
    * ``CascadeConv``, and a ``ParallelConv`` of cascades of one kernel size:
      one depthwise kernel ``W_c = sum_j w2_j[c] (x) w1_j[c]``, exact only
      when the first convs have no bias (``DwSepRep`` builds them so).

    The factors stay in the checkpoint; this changes only the served form.
    """
    if isinstance(module, LowRankExpConvV1):
        C, N, M = module.in_channels, module.out_channels, module.num_base
        d = module.d_conv.weight.float()[:, :, 0, 0].reshape(N, C, M)
        if isinstance(module.s_conv, SeparableConv):
            v = module.s_conv.v_conv.weight.float()[:, 0, :, 0].reshape(C, M, -1)
            h = module.s_conv.h_conv.weight.float()[:, 0, 0, :].reshape(C, M, -1)
            W = torch.einsum("cmu,cmv,ncm->ncuv", v, h, d)
        else:
            s = module.s_conv.weight.float()[:, 0].reshape(C, M, *module.kernel_size)
            W = torch.einsum("cmuv,ncm->ncuv", s, d)
        return _dense_conv(module, W, module.d_conv.bias, module.stride, module.padding)
    if isinstance(module, LowRankExpConvV3):
        W = torch.einsum("rcuv,nr->ncuv", module.basis_conv.weight.float(),
                         module.mix_conv.weight.float()[:, :, 0, 0])
        return _dense_conv(module, W, module.mix_conv.bias, module.stride, module.padding)
    if isinstance(module, LowRankExpConvV4):
        W = torch.einsum("ac,bauv,nb->ncuv", module.in_conv.weight.float()[:, :, 0, 0],
                         module.core_conv.weight.float(),
                         module.out_conv.weight.float()[:, :, 0, 0])
        return _dense_conv(module, W, module.out_conv.bias, module.stride, module.padding)
    if isinstance(module, LowRankExpConvV2):
        if module.grouped:
            return None
        W = torch.einsum("mcu,nmv->ncuv", module.v_conv.weight.float()[:, :, :, 0],
                         module.h_conv.weight.float()[:, :, 0, :])
        return _dense_conv(module, W, module.h_conv.bias,
                           (module.v_conv.stride[0], module.h_conv.stride[1]),
                           (module.v_conv.padding[0], module.h_conv.padding[1]))
    if isinstance(module, CascadeConv):
        cascades = [module]
    elif isinstance(module, ParallelConv):
        cascades = list(module.branches)
        if not all(isinstance(b, CascadeConv) for b in cascades):
            return None  # an identity branch (MSCA's bank) is no conv
    else:
        return None
    if len({c.kernel_size for c in cascades}) != 1 or any(
            c.conv1.bias is not None or c.conv1.stride != (1, 1) or c.conv2.stride != (1, 1)
            for c in cascades):
        return None
    W = sum(c.conv2.weight.float()[:, 0, :, 0, None] * c.conv1.weight.float()[:, 0, 0, None, :]
            for c in cascades)  # (C, k, k)
    biases = [c.conv2.bias.float() for c in cascades if c.conv2.bias is not None]
    pad = cascades[0].conv2.padding[0]
    return _dense_conv(module, W[:, None], sum(biases) if biases else None, 1, pad,
                       groups=module.dim)


def _timer(num_iters: int, dtype=torch.float32) -> Callable:
    """The arbiters' default ``time_fn(model, input_shape) -> seconds`` at the
    serving type ``dtype``: a model whose weights are of another type is timed
    as a cast copy (``cast_floating``), so that the working model keeps its
    float32 weights for the exact rewrites that follow (the JAX planner's
    ``timed``)."""
    from convnet_approximater_tpu_torch.hooks.inference_time_hook import forward_seconds

    def timed(model, input_shape):
        if serving_dtype(model) != dtype:
            model = cast_floating(copy.deepcopy(model), dtype)
        return forward_seconds(model, input_shape, num_iters, warmup=2, dtype=dtype)

    return timed


def never_lose_deploy(model: nn.Module, input_shape, time_fn: Optional[Callable] = None,
                      num_iters: int = 10, margin: float = 0.03, greedy: bool = True,
                      verbose: bool = True, dtype=torch.float32) -> dict:
    """Serve each factored switchable site factored only where the model gains.

    Every site that :func:`rematerialize_dense` rebuilds is a candidate.  Time
    the model with all of them factored, then all dense; when the factored
    model is faster beyond ``margin`` (relative) it stays whole, else, with
    ``greedy``, the sites are factored again one at a time and each kept only
    where the model gains beyond ``margin`` over the best so far.  The model
    is edited in place to the chosen forms.

    ``time_fn(model, input_shape) -> seconds`` times the model (a test injects
    one); the default is ``hooks.forward_seconds`` on a ones batch of the NHWC
    ``input_shape`` in ``dtype``, the serving type the decisions are made at
    (a float32 model is timed as a cast copy): on the card the slope of a CUDA
    graph replayed back to back (``num_iters`` and 4x as many replays after 2
    warm-ups), captured anew for each timing, the eager median logged beside
    it.  Returns the
    JAX package's table: ``t_decomposed``, ``t_dense``, ``t_final`` (seconds),
    ``layers`` (``name``, ``kept``: ``decomposed`` or ``dense``) and
    ``kept_decomposed``.
    """
    time_fn = time_fn if time_fn is not None else _timer(num_iters, dtype_of(dtype))
    logger = get_logger()
    sites = []  # (idx, name, factored module, dense module)
    for idx in range(model.length_switchable):
        mod = model.get_switchable_module(idx)
        dense = rematerialize_dense(mod)
        if dense is not None:
            sites.append((idx, model.switchable_names[idx], mod, dense))
    result = dict(t_decomposed=None, t_dense=None, layers=[], kept_decomposed=0)
    if not sites:
        return result

    def set_site(site, dense: bool):
        idx, _, factored, dense_mod = site
        model.set_switchable_module(idx, dense_mod if dense else factored)

    t_dec = time_fn(model, input_shape)
    for site in sites:
        set_site(site, dense=True)
    t_dense = time_fn(model, input_shape)
    result["t_decomposed"], result["t_dense"] = t_dec, t_dense
    if verbose:
        logger.info(f"never_lose_deploy: decomposed {t_dec * 1e3:.3f} ms vs dense "
                    f"{t_dense * 1e3:.3f} ms ({len(sites)} low-rank layers)")
    if t_dec < t_dense * (1.0 - margin):
        for site in sites:
            set_site(site, dense=False)
        result["layers"] = [dict(name=s[1], kept="decomposed") for s in sites]
        result["kept_decomposed"] = len(sites)
        result["t_final"] = t_dec
        return result

    t_best = t_dense  # the dense model is the floor; re-admit single winners
    for site in sites:
        kept = "dense"
        if greedy:
            set_site(site, dense=False)
            t_try = time_fn(model, input_shape)
            if t_try < t_best * (1.0 - margin):
                t_best, kept = t_try, "decomposed"
                result["kept_decomposed"] += 1
            else:
                set_site(site, dense=True)
        result["layers"].append(dict(name=site[1], kept=kept))
        if verbose:
            logger.info(f"never_lose_deploy: {site[1]} -> {kept} (best {t_best * 1e3:.3f} ms)")
    result["t_final"] = t_best
    return result


def site_generator(seed: int, name: str) -> torch.Generator:
    """The generator of the site ``name``: its draws depend on the seed and the
    name, not on the order in which the sites are visited."""
    return torch.Generator().manual_seed(zlib.crc32(f"{seed}:{name}".encode()))


def arbitrated_apply(model: nn.Module, app, filters, input_shape, seed: int = 0,
                     num_iters: int = 10, margin: float = 0.03, greedy: bool = True,
                     time_fn: Optional[Callable] = None,
                     group_fn: Optional[Callable[[str], object]] = None, verbose: bool = True,
                     decisions: Optional[Dict[str, str]] = None,
                     decisions_path: Optional[str] = None, retime: bool = False,
                     boundary_band: float = 0.02, dtype=torch.float32) -> dict:
    """Apply ``app`` only at the sites where the timed model gains, in place.

    The sites are ``model``'s switchables of ``app.src_type`` that pass
    ``filters``.  Each original is kept as a module (a deep copy made before
    its ``initialize``), so any app can be undone without an inverse.  Apply
    the app at every site (register, initialize, optimize, postprocess; each
    site's new weights drawn from :func:`site_generator` of ``seed`` and its
    name) and time the model; restore every original and time again; when the
    applied model wins beyond ``margin`` (relative) it stays whole, else, with
    ``greedy``, apply one group at a time (``group_fn(site name) -> key``
    groups the sites, default one group each) and keep it only where the model
    gains beyond ``margin`` over the best so far.  A group whose time lands
    within ``boundary_band`` (relative) of that threshold is timed once more
    and decided on the mean of the two readings.

    ``decisions`` (``{site: "applied" | "original"}``), or the JSON table at
    ``decisions_path`` when it exists and ``retime`` is False, replays a
    decided structure with no timing: the app's cursors are rewound, and at
    each original site the app initializes a target it drops, so that every
    applied site gets the target of the measured run.  A table that names none
    of the model's sites is refused.  A measured run writes its table to
    ``decisions_path`` (keys sorted).

    ``time_fn(model, input_shape) -> seconds`` times the model (a test injects
    one); the default is ``hooks.forward_seconds`` at the serving type
    ``dtype``, as :func:`never_lose_deploy` times.  Returns
    ``t_applied``, ``t_original``, ``t_final`` (seconds; None on a replay),
    ``layers`` (``name``, ``kept``), ``kept_applied``, ``decisions``, and
    ``replayed`` on a replay.
    """
    time_fn = time_fn if time_fn is not None else _timer(num_iters, dtype_of(dtype))
    logger = get_logger()
    model.register_switchable(app.src_type, list(filters))
    names = model.switchable_names
    if decisions is None and decisions_path and not retime and os.path.exists(decisions_path):
        with open(decisions_path) as f:
            decisions = json.load(f)
    result = dict(t_applied=None, t_original=None, t_final=None, layers=[], kept_applied=0)
    app.rewind()

    def apply_site(idx: int, name: str) -> nn.Module:
        src = model.get_switchable_module(idx)
        sub = app.initialize(src, site_generator(seed, name)).train(src.training)
        model.set_switchable_module(idx, sub)
        app.optimize(sub)
        new = channels_last(app.postprocess(sub))
        model.set_switchable_module(idx, new)
        return new

    if decisions is not None:
        if names and not set(decisions) & set(names):
            raise ValueError(f"arbitrated_apply: the decisions table names none of the model's "
                             f"sites; table {sorted(decisions)}, sites {names}")
        unknown = sorted(set(decisions) - set(names))
        if unknown:
            logger.warning(f"arbitrated_apply: the decisions table names {unknown}, which "
                           f"are not sites of this model")
        for idx, name in enumerate(names):
            kept = decisions.get(name, "original")
            if kept not in ("applied", "original"):
                raise ValueError(f"arbitrated_apply: {name}: {kept!r} is neither 'applied' "
                                 f"nor 'original'")
            if kept == "applied":
                apply_site(idx, name)
            else:  # advance the app's cursors as the measured run did
                src = model.get_switchable_module(idx)
                app.initialize(src, site_generator(seed, name))
            result["layers"].append(dict(name=name, kept=kept))
            result["kept_applied"] += int(kept == "applied")
        result["replayed"] = True
        result["decisions"] = {r["name"]: r["kept"] for r in result["layers"]}
        logger.info(f"arbitrated_apply[{type(app).__name__}]: replayed "
                    f"{result['kept_applied']}/{len(result['layers'])} applied from the "
                    f"decisions table (retime=True measures again)")
        return result

    sites = []  # (idx, name, original, applied)
    for idx, name in enumerate(names):
        original = copy.deepcopy(model.get_switchable_module(idx))
        sites.append((idx, name, original, apply_site(idx, name)))
    if not sites:
        result["decisions"] = {}
        return result

    def set_site(site, applied: bool):
        idx, _, original, new = site
        model.set_switchable_module(idx, new if applied else original)

    def finish():
        result["decisions"] = {r["name"]: r["kept"] for r in result["layers"]}
        if decisions_path:
            with open(decisions_path, "w") as f:
                json.dump(result["decisions"], f, indent=2, sort_keys=True)
        return result

    t_app = time_fn(model, input_shape)
    for site in sites:
        set_site(site, applied=False)
    t_orig = time_fn(model, input_shape)
    result["t_applied"], result["t_original"] = t_app, t_orig
    if verbose:
        logger.info(f"arbitrated_apply[{type(app).__name__}]: applied {t_app * 1e3:.3f} ms vs "
                    f"original {t_orig * 1e3:.3f} ms ({len(sites)} sites)")
    if t_app < t_orig * (1.0 - margin):
        for site in sites:
            set_site(site, applied=True)
        result["layers"] = [dict(name=s[1], kept="applied") for s in sites]
        result["kept_applied"] = len(sites)
        result["t_final"] = t_app
        return finish()

    groups: Dict[object, list] = {}
    for site in sites:
        groups.setdefault(site[1] if group_fn is None else group_fn(site[1]), []).append(site)
    t_best = t_orig
    for group in groups.values():
        kept = "original"
        if greedy:
            for site in group:
                set_site(site, applied=True)
            t_try = time_fn(model, input_shape)
            threshold = t_best * (1.0 - margin)
            if abs(t_try - threshold) <= boundary_band * t_best:
                # near the threshold one reading decides on noise: take the mean of two
                t_try = 0.5 * (t_try + time_fn(model, input_shape))
            if t_try < threshold:
                t_best, kept = t_try, "applied"
                result["kept_applied"] += len(group)
            else:
                for site in group:
                    set_site(site, applied=False)
        result["layers"].extend(dict(name=s[1], kept=kept) for s in group)
        if verbose:
            logger.info(f"arbitrated_apply: {','.join(s[1] for s in group)} -> {kept} "
                        f"(best {t_best * 1e3:.3f} ms)")
    result["t_final"] = t_best
    return finish()


class _Snapshot:
    """What a captured graph relies on: every child, parameter and buffer slot of
    every module of ``model``, what each holds, and each tensor's address and
    version counter.  :meth:`holds` tells whether all are as they were; it
    reads the slots directly, a few times faster than walking
    ``model.parameters()`` for ``params_key``."""

    def __init__(self, model: nn.Module):
        self.dicts = [(d, len(d)) for m in model.modules()
                      for d in (m._modules, m._parameters, m._buffers)]
        self.items = [(d, k, v) for d, _ in self.dicts for k, v in d.items()]
        self.tensors = [v for _, _, v in self.items if isinstance(v, torch.Tensor)]
        self.versions = [(t.data_ptr(), t._version) for t in self.tensors]

    def holds(self) -> bool:
        return (all(len(d) == n for d, n in self.dicts)
                and all(d.get(k) is v for d, k, v in self.items)
                and [(t.data_ptr(), t._version) for t in self.tensors] == self.versions)


def _capture(graph, model: nn.Module, static):
    """The capture of ``model(*static)`` into ``graph``; a forward that cannot
    be captured (one that waits on the card: ``.item()``, a bool of a tensor)
    raises naming the innermost module it was in."""
    entered: List[Tuple[str, nn.Module]] = []

    def leave(mod, args, out):
        entered.pop()  # returns None: a forward hook's value would replace the output

    handles = []
    for name, m in model.named_modules():
        handles.append(m.register_forward_pre_hook(
            lambda mod, args, name=name: entered.append((name, mod))))
        handles.append(m.register_forward_hook(leave))
    try:
        with torch.no_grad(), torch.cuda.graph(graph):
            out = model(*static)
    except Exception as e:
        name, mod = entered[-1] if entered else ("", model)
        raise RuntimeError(f"compile_serving: the forward cannot be captured as a CUDA graph: "
                           f"it failed in module '{name or '<model>'}' "
                           f"({type(mod).__name__}): {e}") from e
    finally:
        for h in handles:
            h.remove()
    return out


def compile_serving(model: nn.Module, *example_args: torch.Tensor):
    """The eval forward of ``model`` as a serving session: returns ``(compiled, put)``.

    ``put(*args)`` copies a batch into the session's static inputs (shaped as
    ``example_args``) and returns them; ``compiled(*args)`` puts ``args``, if
    given, runs the forward on the static inputs and returns logits that the
    caller owns.  This is the counterpart of the JAX package's
    ``compile_serving`` (an executable compiled with XLA's input layouts).

    On a CUDA model the forward is one ``torch.cuda.CUDAGraph``
    (``compiled.graph``), captured under ``torch.no_grad()`` (with autograd on,
    the kernel layers would take their module paths).  Three eval forwards on a
    side stream first fill every per-weight-version cache (the kernels' packed
    weights and layouts, the border-fix maps) and build and load the kernels,
    so that the capture records the steady-state forward; the kernels launch
    on the current stream, which is the capture stream.  A capture that fails
    raises naming the module it failed in; nothing runs eager in its place.
    The graph reads the weights, the caches and the tensor maps it froze by
    address, so ``compiled`` raises once a parameter or buffer has been
    modified or replaced, or a module swapped: compile again after that.  The
    graph's memory pool is freed with the last reference to ``compiled``.

    On a CPU model ``compiled`` runs the eager forward under ``torch.no_grad()``,
    with the same contract.  A spatially sharded model (``parallel/spatial.py``)
    raises ``NotImplementedError``: a graph cannot capture gloo's host round trips.
    """
    from convnet_approximater_tpu_torch.parallel.spatial import is_spatial, refuse_spatial

    if is_spatial(model):
        raise refuse_spatial("compile_serving of a spatially sharded model (a CUDA graph "
                             "cannot capture the halo exchanges' host round trips)")
    if model.training:
        model.eval()
    device = next(model.parameters()).device
    static = [torch.empty_like(a, device=device).copy_(a) for a in example_args]
    graph, out = None, None
    if device.type == "cuda":
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side), torch.no_grad():
            for _ in range(3):
                model(*static)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        out = _capture(graph, model, static)
    snapshot = _Snapshot(model)

    def put(*args: torch.Tensor):
        if len(args) != len(static):
            raise ValueError(f"compile_serving: {len(static)} inputs, got {len(args)}")
        for s, a in zip(static, args):
            if a is not s:
                if a.shape != s.shape:
                    raise ValueError(f"compile_serving: input of shape {tuple(a.shape)}, "
                                     f"compiled for {tuple(s.shape)}")
                s.copy_(a)
        return tuple(static)

    def compiled(*args: torch.Tensor) -> torch.Tensor:
        if not snapshot.holds():
            raise RuntimeError("compile_serving: a module, parameter or buffer of the model "
                               "changed after compile_serving; compile the model again")
        if args:
            put(*args)
        if graph is None:
            with torch.no_grad():
                return model(*static)
        graph.replay()
        return out.clone()

    compiled.graph = graph
    return compiled, put


# -- serving artifacts and batch wrappers ---------------------------------
SERVING_META = "serving.json"  # the artifact's input and output contract, beside the program
MAX_SYMBOLIC_BATCH = 65535     # the card's convolutions take at most 65535 images in a call


class Aval(NamedTuple):
    """One input or output of a serving artifact: its shape (``None`` for the
    symbolic batch), dtype and memory format: the JAX ``in_avals``/``out_avals``."""
    shape: Tuple[Optional[int], ...]
    dtype: torch.dtype
    memory_format: str


def _channels_last(t: torch.Tensor) -> bool:
    return (t.dim() == 4 and not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last))


def _aval(t: torch.Tensor, symbolic: bool) -> dict:
    shape = [None if symbolic and i == 0 else int(d) for i, d in enumerate(t.shape)]
    return dict(shape=shape, dtype=str(t.dtype).removeprefix("torch."),
                memory_format="channels_last" if _channels_last(t) else "contiguous")


def check_platforms(platforms, device_type: str) -> None:
    """Raise unless every platform of ``platforms`` (None: the model's own) is
    ``device_type``: a ``torch.export`` program holds one device's weights."""
    if platforms is not None and any(p != device_type for p in platforms):
        raise ValueError(
            f"export_serving: platforms {list(platforms)}: the JAX package lowers one "
            f"StableHLO module for several platforms, but a torch.export program holds "
            f"the weights of the model's device ({device_type}); export once per device")


def export_serving(model: nn.Module, example_args: Sequence[torch.Tensor], path=None,
                   symbolic_batch: bool = False, platforms=None) -> bytes:
    """Serialize the eval forward of ``model`` to a ``torch.export`` artifact.

    The counterpart of the JAX package's ``export_serving`` (a StableHLO module
    from ``jax.export``).  ``torch.export`` traces ``model(*example_args)``
    once under ``torch.no_grad()`` in eval mode, so the kernel layers take
    their kernels, and ``torch.export.save`` writes the program with its
    weights; the result is returned as bytes and, with ``path``, written there.
    The kernels are the port's custom ops: loading the artifact needs the
    port's ``ops`` registered (:func:`load_serving` imports them), not the
    model code, config or checkpoint loader.

    An eval forward runs first, to fill every per-weight-version cache; the
    trace then reads the caches as they are (``nn.frozen_params_keys``), so
    the program holds the kernels' packed layouts and the border maps as
    constants, computed once, as the live model holds them.

    ``symbolic_batch``: dim 0 of the last argument (the input batch) is
    exported as a ``torch.export.Dim`` up to ``MAX_SYMBOLIC_BATCH``, so one
    artifact serves any batch size in its ``batch_range``.  On the card the
    range starts at 2: tracing a convolution there picks its cuDNN backend
    from the batch, which guards b != 1 (and b <= 65535), so a batch of 1 is
    served padded to 2 (:func:`pad_batch`, as ``serve`` does by default); on
    the CPU it starts at 1.  ``platforms``: the JAX package lowers one module for
    several platforms (e.g. ``("tpu", "cpu")``); a ``torch.export`` program
    holds the weights of one device, so any platform other than the model's
    device type raises: export once per device.
    """
    device = next(model.parameters()).device
    check_platforms(platforms, device.type)
    example_args = tuple(example_args)
    dynamic_shapes, batch_range = None, None
    if symbolic_batch:
        batch_range = (2 if device.type == "cuda" else 1, MAX_SYMBOLIC_BATCH)
        dynamic_shapes = tuple(None for _ in example_args[:-1]) + (
            {0: torch.export.Dim("batch", min=batch_range[0], max=batch_range[1])},)
    if model.training:
        model.eval()
    with torch.no_grad():
        outs = model(*example_args)
        with frozen_params_keys():
            program = torch.export.export(model, example_args, dynamic_shapes=dynamic_shapes,
                                          strict=False)
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    meta = dict(inputs=[_aval(a, symbolic_batch and i == len(example_args) - 1)
                        for i, a in enumerate(example_args)],
                outputs=[_aval(o, symbolic_batch) for o in outs], device=device.type,
                batch_range=batch_range)
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={SERVING_META: json.dumps(meta)})
    data = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


def load_serving(path_or_bytes, device=None) -> nn.Module:
    """Load an :func:`export_serving` artifact; returns its module.

    The port's ``ops`` are imported first, so that the kernels' custom ops are
    registered.  The module takes the positional inputs the exported forward
    took, and exposes its contract as ``in_avals``/``out_avals`` (tuples of
    :class:`Aval`), as the JAX package's loaded artifact does, and
    ``batch_range``, the least and the largest batch of a symbolic-batch
    artifact (None for a static one).  Its parameters
    take no gradient; serve it on the card through :func:`compile_serving`
    (one CUDA graph per batch size, as XLA compiles once per size).
    ``device``: where to serve it (a rank's own card); a program exported on
    another card is moved there (``torch.export.passes.move_to_device_pass``).
    """
    from convnet_approximater_tpu_torch.ops import (lowrank_conv, msca_fused,  # noqa: F401
                                                    parallel_cascade, qmatmul)

    data = path_or_bytes
    if not isinstance(data, (bytes, bytearray)):
        with open(data, "rb") as f:
            data = f.read()
    extra = {SERVING_META: ""}
    program = torch.export.load(io.BytesIO(bytes(data)), extra_files=extra)
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        held = next((t.device for t in program.state_dict.values()), device)
        if held != device:
            from torch.export.passes import move_to_device_pass

            program = move_to_device_pass(program, device)
    module = program.module()
    module.requires_grad_(False)
    for m in module.modules():  # exported in eval mode; the loaded module refuses .eval()
        m.training = False
    meta = json.loads(extra[SERVING_META])

    def avals(entries):
        return tuple(Aval(tuple(e["shape"]), getattr(torch, e["dtype"]), e["memory_format"])
                     for e in entries)

    module.in_avals, module.out_avals = avals(meta["inputs"]), avals(meta["outputs"])
    module.batch_range = tuple(meta["batch_range"]) if meta.get("batch_range") else None
    return module


def custom_op_counts(program_or_module) -> Dict[str, int]:
    """Calls of each of the port's kernel ops in an exported program's (or a
    loaded module's) graph: one forward's launches of each kernel."""
    from convnet_approximater_tpu_torch.ops.build import NAMESPACE

    graph = program_or_module.graph
    counts: Dict[str, int] = {}
    for node in graph.nodes:
        target = getattr(node.target, "namespace", None)
        if node.op == "call_function" and target == NAMESPACE:
            name = node.target.overloadpacket.__name__
            counts[name] = counts.get(name, 0) + 1
    return counts


def _batch_major(name: str, n: int):
    def check(a):
        if getattr(a, "ndim", 0) < 1 or a.shape[0] != n:
            raise ValueError(f"{name}: output leaf of shape {tuple(getattr(a, 'shape', ()))} "
                             f"has no leading batch dim == {n}; {name} only wraps forwards "
                             f"whose outputs are all batch-major")
        return a
    return check


def _padded(name: str, fn: Callable, args, n: int):
    """``fn`` on the batch (the last of ``args``) with its rows repeated up to
    ``n`` rows, in the batch's memory format; every output leaf sliced back."""
    x = args[-1]
    fmt = torch.channels_last if _channels_last(x) else torch.contiguous_format
    tiled = torch.cat([x] * -(-n // x.shape[0]), dim=0)[:n].contiguous(memory_format=fmt)
    check = _batch_major(name, n)
    return tree_map(lambda a: check(a)[:x.shape[0]], fn(*args[:-1], tiled))


def pad_batch(fn: Callable, min_batch: int = 2) -> Callable:
    """Serving wrapper: run sub-``min_batch`` inputs at ``min_batch``.

    The last positional argument is the input batch (dim 0 of an NCHW
    ``channels_last`` tensor); a batch below ``min_batch`` is tiled up to
    ``min_batch`` rows and every output leaf (a pytree of tensors) is sliced
    back.  Every output leaf must carry the batch as its leading dim, or a
    ``ValueError`` says so.  The JAX package found b=1 degenerate on the v5e's
    batch tiling; whether b=1 pays on the card is measured, not assumed.
    """

    def wrapped(*args):
        if args[-1].shape[0] >= min_batch:
            return fn(*args)
        return _padded("pad_batch", fn, args, min_batch)

    return wrapped


def pad_batch_to_multiple(fn: Callable, multiple: int) -> Callable:
    """Serving wrapper: pad any batch up to the next multiple of ``multiple``
    (a data-parallel serve shards the batch over the cards), tiling rows as
    :func:`pad_batch` does and slicing every batch-major output leaf back."""
    if multiple < 1:
        raise ValueError(f"pad_batch_to_multiple: multiple={multiple}")

    def wrapped(*args):
        b = args[-1].shape[0]
        if b % multiple == 0:
            return fn(*args)
        return _padded("pad_batch_to_multiple", fn, args, -(-b // multiple) * multiple)

    return wrapped


def chunk_batch(fn: Callable, max_batch: int = 128) -> Callable:
    """Serving wrapper: run an over-``max_batch`` input as sequential chunks of
    ``max_batch`` rows (the last one smaller) and concatenate every output
    leaf along dim 0; each chunk's leaves must be batch-major.  Compose as
    ``chunk_batch(pad_batch(fn, 2), knee)`` to clamp both ends (pad inside
    chunk, so a remainder chunk of one row is padded too)."""

    def wrapped(*args):
        x = args[-1]
        b = x.shape[0]
        if b <= max_batch:
            return fn(*args)
        starts = range(0, b, max_batch)
        ys = [fn(*args[:-1], x[i:i + max_batch]) for i in starts]
        leaves, spec = zip(*(tree_flatten(y) for y in ys))
        cat = []
        for parts in zip(*leaves):
            for a, i in zip(parts, starts):
                _batch_major("chunk_batch", min(max_batch, b - i))(a)
            cat.append(torch.cat(parts, dim=0))
        return tree_unflatten(cat, spec[0])

    return wrapped

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
* :func:`compile_serving` captures the eval forward into a CUDA graph.

The names are the JAX package's, so a config's ``structure_passes`` find them.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from convnet_approximater_tpu_torch.layers.quant import (QATConv2d, QATLinear, QuantConv2d,
                                                         QuantLinear)
from convnet_approximater_tpu_torch.layers.substitution import Substitution
from convnet_approximater_tpu_torch.models.switchable import set_submodule
from convnet_approximater_tpu_torch.nn import (GELU, AdaptiveAvgPool2d, BatchNorm2d, Conv2d,
                                               Dropout, Identity, Linear, MaxPool2d, ReLU)
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
    narrows the set further.
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

    model.eval()
    handles = [m.register_forward_pre_hook(observe(path)) for path, m in targets]
    n_batches = 0
    try:
        with torch.no_grad():
            for x in calib_batches:
                model(x)
                n_batches += 1
    finally:
        for h in handles:
            h.remove()
    if n_batches == 0:
        raise ValueError("quantize_int8 needs at least one calibration batch")
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


def compile_serving(model: nn.Module, *example_args: torch.Tensor):
    """The eval forward of ``model`` as a serving session: returns ``(compiled, put)``.

    ``put(*args)`` copies a batch into the session's static inputs (shaped as
    ``example_args``) and returns them; ``compiled(*args)`` puts ``args``, if
    given, runs the forward on the static inputs and returns logits that the
    caller owns.  This is the counterpart of the JAX package's
    ``compile_serving`` (an executable compiled with XLA's input layouts).

    On a CUDA model the forward is one ``torch.cuda.CUDAGraph``, captured under
    ``torch.no_grad()`` (with autograd on, the kernel layers would take their
    module paths).  Three eval forwards on a side stream first fill every
    per-weight-version cache (the kernels' packed weights and layouts, the
    border-fix maps) and build and load the kernels, so that the capture
    records the steady-state forward; the kernels launch on the current
    stream, which is the capture stream.  A capture that fails raises; nothing
    runs eager in its place.  The graph reads the weights, the caches and the
    tensor maps it froze by address, so ``compiled`` raises once a parameter
    or buffer has been modified or replaced, or a module swapped: compile
    again after that.

    On a CPU model ``compiled`` runs the eager forward under ``torch.no_grad()``,
    with the same contract.
    """
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
        with torch.no_grad(), torch.cuda.graph(graph):
            out = model(*static)
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

    return compiled, put

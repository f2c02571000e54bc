"""Serving rewrites of a model (port of ``convnet_approximater_tpu/deploy.py``).

* :func:`fold_batchnorm` folds eval-mode BatchNorm into the conv(s) that feed it;
* :func:`enable_pw_matmul` runs every pointwise conv as a matrix product over
  its NHWC view;
* :func:`quantize_int8` is int8 post-training quantization;
* :func:`prepare_qat` swaps dense convs and Linears for their fake-quant
  training twins, and :func:`convert_qat_to_int8` turns the trained twins into
  the int8 serving modules;
* :func:`compile_serving` captures the eval forward into a CUDA graph.

The names are the JAX package's, so a config's ``structure_passes`` find them.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from convnet_approximater_tpu_torch.layers.quant import (QATConv2d, QATLinear, QuantConv2d,
                                                         QuantLinear)
from convnet_approximater_tpu_torch.layers.substitution import Substitution
from convnet_approximater_tpu_torch.models.switchable import set_submodule
from convnet_approximater_tpu_torch.nn import BatchNorm2d, Conv2d, Identity, Linear

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

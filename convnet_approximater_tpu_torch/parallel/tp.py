"""Tensor-parallel sharding rules and the sharding of a module over the
mesh's ``model`` axis (port of ``convnet_approximater_tpu/parallel/tp.py``).

Config surface (``other_args`` for ``L2Reconstruct``, top level for
``TrainHelper``), the JAX package's:

* ``model_parallel: int``: the size of the model axis (1: data parallelism only);
* ``tp_rules``: a preset name (``"mscan"``, ``"convnext"``, ``"resnet"``,
  ``"vgg"``, ``"alexnet"``), None or ``""`` (the ``mscan`` preset), or an
  explicit list of ``(path_suffix, spec)`` pairs, ``spec`` a tuple of axis
  names or None in the JAX layout, e.g. ``[("head/weight", (None, "model"))]``.
  The suffixes are JAX param paths (``parallel/mesh.py::param_shardings``),
  so a config written for the JAX package works here as it is.

The JAX package lays the parameters out with ``NamedSharding`` and XLA
inserts the collectives.  Here :func:`shard_module` keeps on each rank only
its slice of every parameter a rule shards (and of the running statistics of
a BatchNorm whose affine is sharded), and gives each such layer its sharded
form (``parallel/tp_layers.py``): the presets' Megatron pairs, which the
models name in ``TP_CHAINS`` (MSCAN's ``fc1 -> dconv -> fc2``, ConvNeXt's
``pwconv1 -> pwconv2``, a ResNet block's ``conv1 -> bn1 -> conv2``, the
VGG/AlexNet classifier's ``fc1 -> fc2``), keep the hidden activation sharded
between the two halves with one ``all_reduce``; any other sharded layer
gathers its output, or its parameters, so any rule list gives the
replicated forward.  :func:`unshard_module` gathers the whole model back.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from . import tp_layers
from .mesh import MODEL_AXIS, axis_ranks, param_shardings, replicate
from .spatial import is_spatial, refuse_spatial


def P(*axes) -> tuple:
    """A partition spec as the plain tuple of its axes (the JAX ``PartitionSpec``)."""
    return tuple(axes)


def int8_aliases(rules):
    """The int8-serving twins of a preset's ``*/weight`` rules.

    ``deploy.quantize_int8`` turns dense convs and Linears into
    ``QuantConv2d``/``QuantLinear``, whose ``weight`` is ``weight_q`` (with a
    per-output-channel ``w_scale`` and a scalar ``act_scale``).  For each
    ``X/weight`` rule, ``X/weight_q`` takes the same spec; where the spec
    shards the output channels (its last JAX axis), ``X/w_scale`` and
    ``X/bias`` follow with a 1-d shard (a row shard leaves the per-output
    scale replicated); a full-path (``^``) pin also pins its scale and bias,
    or the block-level aliases would catch them.  Every alias is optional."""
    out = []
    for pat, spec in rules:
        if not pat.endswith("/weight"):
            continue
        base = "?" + pat[: -len("/weight")]
        out.append((base + "/weight_q", spec))
        axes = tuple(spec)
        if axes and axes[-1] == MODEL_AXIS:
            out.append((base + "/w_scale", P(MODEL_AXIS)))
            out.append((base + "/bias", P(MODEL_AXIS)))
        elif pat.startswith("^"):
            out.append((base + "/w_scale", P()))
            out.append((base + "/bias", P()))
    return out


def _with_int8(rules):
    return rules + int8_aliases(rules)


def mscan_tp_rules():
    """MSCAN: the classifier head and the channel-mix 1x1 convs
    column-sharded; the FFN's fc1 column-sharded over the hidden dim, its
    depthwise dconv over that same sharded dim, fc2 row-sharded."""
    return _with_int8([
        ("head/weight", P(None, MODEL_AXIS)),
        ("head/bias", P(MODEL_AXIS)),
        ("channel_mix/weight", P(None, None, None, MODEL_AXIS)),
        ("channel_mix/bias", P(MODEL_AXIS)),
        ("fc1/weight", P(None, None, None, MODEL_AXIS)),
        ("fc1/bias", P(MODEL_AXIS)),
        ("dconv/weight", P(None, None, None, MODEL_AXIS)),
        ("dconv/bias", P(MODEL_AXIS)),
        ("fc2/weight", P(None, None, MODEL_AXIS, None)),
    ])


def convnext_tp_rules():
    """ConvNeXt: the block MLP's pwconv1 column-sharded over the 4x hidden
    dim, pwconv2 row-sharded; the head column-sharded.  The depthwise 7x7 and
    the norms stay replicated."""
    return _with_int8([
        ("head/weight", P(None, MODEL_AXIS)),
        ("head/bias", P(MODEL_AXIS)),
        ("pwconv1/weight", P(None, MODEL_AXIS)),
        ("pwconv1/bias", P(MODEL_AXIS)),
        ("pwconv2/weight", P(MODEL_AXIS, None)),
    ])


def resnet_tp_rules():
    """ResNet: in every block conv1 column-sharded (bn1's affine follows) and
    conv2 row-sharded; Bottleneck's conv3, the downsample projections and the
    stem replicated; the ``fc`` head column-sharded.  The ``^`` rules pin the
    stem, whose names are suffixes of the blocks'."""
    return _with_int8([
        ("^conv1/weight", P()),
        ("^bn1/scale", P()), ("^bn1/bias", P()),
        ("conv1/weight", P(None, None, None, MODEL_AXIS)),
        ("bn1/scale", P(MODEL_AXIS)),
        ("bn1/bias", P(MODEL_AXIS)),
        ("conv2/weight", P(None, None, MODEL_AXIS, None)),
        ("fc/weight", P(None, MODEL_AXIS)),
        ("fc/bias", P(MODEL_AXIS)),
    ])


def _classifier_megatron(fc1: str, fc2: str, head: str):
    """fc1 column, fc2 row, the head column: where VGG and AlexNet keep most
    of their parameters."""
    return _with_int8([
        (f"classifier/{fc1}/weight", P(None, MODEL_AXIS)),
        (f"classifier/{fc1}/bias", P(MODEL_AXIS)),
        (f"classifier/{fc2}/weight", P(MODEL_AXIS, None)),
        (f"classifier/{head}/weight", P(None, MODEL_AXIS)),
        (f"classifier/{head}/bias", P(MODEL_AXIS)),
    ])


def vgg_tp_rules():
    """VGG's classifier Linears sit at Sequential slots 0, 3 and 6."""
    return _classifier_megatron("0", "3", "6")


def alexnet_tp_rules():
    """AlexNet's classifier Linears sit at Sequential slots 1, 4 and 6."""
    return _classifier_megatron("1", "4", "6")


_PRESETS = {"mscan": mscan_tp_rules, "convnext": convnext_tp_rules,
            "resnet": resnet_tp_rules, "vgg": vgg_tp_rules, "alexnet": alexnet_tp_rules}


def resolve_tp_rules(spec) -> list:
    """A config's ``tp_rules`` as ``[(suffix, spec tuple)]``."""
    if spec is None or spec == "":
        return mscan_tp_rules()
    if isinstance(spec, str):
        if spec not in _PRESETS:
            raise KeyError(f"unknown tp_rules preset {spec!r}; available: {sorted(_PRESETS)}")
        return _PRESETS[spec]()
    return [(str(suffix), tuple(axes)) for suffix, axes in spec]


# -- the plan ------------------------------------------------------------------
class TPPlan:
    """A sharded model's layout: its model axis, and per parameter or buffer
    name the dim its slice was taken along (the sharded ones only).  A copy of
    the model shares it."""

    def __init__(self, axis: tp_layers.ModelAxis, dims: Dict[str, int]):
        self.axis, self.dims = axis, dict(dims)

    def __deepcopy__(self, memo):
        return self


def tp_plan(model: nn.Module) -> Optional[TPPlan]:
    """The plan :func:`shard_module` left on ``model``, or None."""
    return model.__dict__.get("_tp_plan")


def _chan(m: nn.Module) -> int:
    """The channel dim of a layer's activations: last for a ``Linear``, 1 for a map."""
    return -1 if _kind(m) == "linear" else 1


def _kind(m: nn.Module) -> Optional[str]:
    from convnet_approximater_tpu_torch.layers.quant import QuantConv2d, QuantLinear
    from convnet_approximater_tpu_torch.nn import BatchNorm2d

    if isinstance(m, QuantConv2d):
        return "conv"
    if isinstance(m, QuantLinear):
        return "linear"
    if isinstance(m, nn.Conv2d):
        return "conv"
    if isinstance(m, nn.Linear):
        return "linear"
    if isinstance(m, BatchNorm2d):
        return "bn"
    return None


def _col_ok(m: nn.Module, dims: Dict[str, Optional[int]], size: int) -> bool:
    """Whether ``m`` computes its output channels from the shards of ``dims``:
    the weight sharded over its output channels, any bias and scale over them
    too or replicated, nothing else sharded."""
    kind = _kind(m)
    if kind not in ("conv", "linear"):
        return False
    w = tp_layers._weight_name(m)
    if dims.get(w) != 0:
        return False
    if any(d is not None and not (n in ("bias", "w_scale") and d == 0)
           for n, d in dims.items() if n != w):
        return False
    groups = getattr(m, "groups", 1)
    return groups == 1 or groups % size == 0


def _row_ok(m: nn.Module, dims: Dict[str, Optional[int]]) -> bool:
    """Whether ``m`` computes a partial sum over its input-channel shard: a
    dense conv or ``Linear`` (or int8 form) with only its weight sharded, over
    the input channels.  A QAT twin is not: its fake-quant grid spans the
    whole input."""
    from convnet_approximater_tpu_torch.layers.quant import QATConv2d, QATLinear

    if _kind(m) not in ("conv", "linear") or isinstance(m, (QATConv2d, QATLinear)):
        return False
    w = tp_layers._weight_name(m)
    return (dims.get(w) == 1 and getattr(m, "groups", 1) == 1
            and all(d is None for n, d in dims.items() if n != w))


def _bn_ok(m: nn.Module, dims: Dict[str, Optional[int]]) -> bool:
    return _kind(m) == "bn" and dims.get("weight") == 0 and dims.get("bias") == 0


def _local_ok(m: nn.Module, dims: Dict[str, Optional[int]], size: int) -> bool:
    """A layer that maps the rank's channels to the rank's channels: a
    BatchNorm with its affine sharded, or a depthwise conv column-sharded."""
    if _bn_ok(m, dims):
        return True
    return (_kind(m) == "conv" and _col_ok(m, dims, size)
            and m.groups == m.in_channels == m.out_channels)


def _free(m: nn.Module) -> bool:
    """A parameter-free elementwise layer a sharded activation passes as it is."""
    from convnet_approximater_tpu_torch.nn import GELU, Dropout

    return isinstance(m, (nn.ReLU, nn.GELU, GELU, nn.Identity, Dropout)) and not any(
        True for _ in m.parameters())


def _chains(model: nn.Module, leaf_dims: Dict[str, dict], size: int) -> Iterable[list]:
    """The active Megatron pairs: per ``TP_CHAINS`` entry of a container whose
    first layer is column-sharded (``groups == 1``), last row-sharded, and every
    layer between sharded along (or free of parameters), its layers' names."""
    for cname, c in model.named_modules():
        for chain in getattr(type(c), "TP_CHAINS", ()):
            names = [f"{cname}.{n}" if cname else n for n in chain]
            try:
                mods = [model.get_submodule(n) for n in names]
            except AttributeError:
                continue
            first, last = mods[0], mods[-1]
            if not (_col_ok(first, leaf_dims.get(names[0], {}), size)
                    and getattr(first, "groups", 1) == 1
                    and _row_ok(last, leaf_dims.get(names[-1], {}))):
                continue
            if all(_free(m) if n not in leaf_dims else _local_ok(m, leaf_dims[n], size)
                   for n, m in zip(names[1:-1], mods[1:-1])):
                yield names


def _check_divisible(name: str, shape, dim: int, size: int) -> None:
    if shape[dim] % size:
        raise ValueError(f"shard_module: {name} of shape {tuple(shape)} is sharded over its dim "
                         f"{dim} by a model axis of {size}, which implies that the global size "
                         f"of its dimension {dim} should be divisible by {size}, but it is "
                         f"equal to {shape[dim]}")


@torch.no_grad()
def _keep_slice(module: nn.Module, store: str, name: str, dim: int, axis) -> None:
    """Replace ``module``'s parameter or buffer ``name`` by this rank's slice of it."""
    table = getattr(module, store)
    t = table[name]
    local = tp_layers._dense_like(tp_layers.local_slice(t.detach(), dim, axis)).clone(
        memory_format=torch.preserve_format)
    table[name] = (nn.Parameter(local, requires_grad=t.requires_grad) if store == "_parameters"
                   else local)


def shard_module(model: nn.Module, mesh, model_parallel: int = 1, tp_rules=None,
                 warn: bool = True) -> nn.Module:
    """Lay ``model`` out over ``mesh`` (port of JAX ``shard_variables``), in place.

    ``model_parallel <= 1``: every parameter and buffer replicated
    (:func:`~.mesh.replicate`: the data group's first rank's).  Above 1 (the
    mesh's model axis must have that size): each parameter a rule of
    ``tp_rules`` (:func:`resolve_tp_rules`) shards keeps this rank's slice, and
    its layer the sharded form of ``parallel/tp_layers.py``; a dim the axis
    does not divide raises ``ValueError`` (as JAX's ``device_put`` does).
    Every rank must call it with the same weights (``replicate`` first)."""
    if model_parallel <= 1:
        return replicate(model, mesh)
    if is_spatial(model):
        raise refuse_spatial("tensor parallelism (model_parallel > 1) of a spatially sharded "
                             "model")
    if tp_plan(model) is not None:
        raise ValueError("shard_module: the model is sharded already")
    index, size, group, ranks = axis_ranks(mesh, MODEL_AXIS)
    if size != model_parallel:
        raise ValueError(f"shard_module: model_parallel={model_parallel} but the mesh's model "
                         f"axis has {size} ranks")
    axis = tp_layers.ModelAxis(index, size, group, tuple(ranks))
    dims = {n: d for n, d in param_shardings(model, mesh, resolve_tp_rules(tp_rules),
                                             warn=warn).items() if d is not None}
    params = dict(model.named_parameters())
    for name, d in dims.items():
        _check_divisible(name, params[name].shape, d, size)
    leaf_dims: Dict[str, dict] = {}
    for name in dims:
        leaf_dims.setdefault(name.rpartition(".")[0], {})
    for leaf in leaf_dims:
        m = model.get_submodule(leaf)
        leaf_dims[leaf] = {n: dims.get(f"{leaf}.{n}" if leaf else n)
                           for n, p in m._parameters.items() if p is not None}
    roles: Dict[str, tp_layers.LeafTP] = {}
    for names in _chains(model, leaf_dims, size):
        chan = _chan(model.get_submodule(names[0]))  # the pair's activations
        for n in names:
            m = model.get_submodule(n)
            if n == names[0]:
                roles[n] = tp_layers.LeafTP("col", leaf_dims[n], axis, "rep", "local", chan)
            elif n == names[-1]:
                roles[n] = tp_layers.LeafTP("row", leaf_dims[n], axis, "local", "reduce", chan)
            elif n in leaf_dims:
                roles[n] = tp_layers.LeafTP("local", leaf_dims[n], axis, "local", "local", chan)
            elif hasattr(m, "tp_slice"):  # a Dropout between the halves: its mask's columns
                m.tp_slice = (chan, index, size)
    for leaf, ld in leaf_dims.items():
        if leaf in roles:
            continue
        m = model.get_submodule(leaf)
        chan = _chan(m)
        if _col_ok(m, ld, size):
            roles[leaf] = tp_layers.LeafTP("col", ld, axis,
                                           "rep" if getattr(m, "groups", 1) == 1 else "scatter",
                                           "gather", chan)
        elif _row_ok(m, ld):
            roles[leaf] = tp_layers.LeafTP("row", ld, axis, "scatter", "reduce", chan)
        elif _bn_ok(m, ld):
            roles[leaf] = tp_layers.LeafTP("col", ld, axis, "scatter", "gather", 1)
        else:
            roles[leaf] = tp_layers.LeafTP("gathered", ld, axis)
    plan_dims = dict(dims)
    for leaf, tp in roles.items():
        m = model.get_submodule(leaf)
        prefix = f"{leaf}." if leaf else ""
        for n, d in tp.dims.items():
            if d is not None:
                _keep_slice(m, "_parameters", n, d, axis)
        if _kind(m) == "bn" and tp.role != "gathered":  # its running statistics follow
            for n in ("running_mean", "running_var"):
                if m._buffers.get(n) is not None:
                    _check_divisible(prefix + n, m._buffers[n].shape, 0, size)
                    _keep_slice(m, "_buffers", n, 0, axis)
                    plan_dims[prefix + n] = 0
        tp_layers.install(m, tp)
    model.__dict__["_tp_plan"] = TPPlan(axis, plan_dims)
    return model


def layouts(model: nn.Module) -> Dict[str, tp_layers.LeafTP]:
    """Each sharded layer's form, by name."""
    return {n: m.__dict__["_tp"] for n, m in model.named_modules() if "_tp" in m.__dict__}


@torch.no_grad()
def unshard_module(model: nn.Module) -> nn.Module:
    """Gather every sharded parameter and buffer of ``model`` back to the whole
    tensor and give each layer its own forward again.  Collective over the
    model axis; a no-op on a model that is not sharded."""
    plan = tp_plan(model)
    if plan is None:
        return model
    for name, d in plan.dims.items():
        leaf, _, n = name.rpartition(".")
        m = model.get_submodule(leaf)
        store = "_parameters" if n in m._parameters else "_buffers"
        t = getattr(m, store)[n]
        whole = tp_layers.all_gather_dim(t.detach(), d, plan.axis)
        if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
            whole = whole.contiguous(memory_format=torch.channels_last)
        getattr(m, store)[n] = (nn.Parameter(whole, requires_grad=t.requires_grad)
                                if store == "_parameters" else whole)
    for m in model.modules():
        tp_layers.uninstall(m)
        if getattr(m, "tp_slice", None) is not None:
            m.tp_slice = None
    from convnet_approximater_tpu_torch.nn import drop_weight_caches

    drop_weight_caches(model)
    del model.__dict__["_tp_plan"]
    return model


def gather_tensor(plan: TPPlan, name: str, t: torch.Tensor) -> torch.Tensor:
    """The whole of ``t``, this rank's slice of the tensor ``name`` (or of its
    optimizer state), gathered over the model axis; ``t`` where ``name`` is
    not sharded.  Collective."""
    d = plan.dims.get(name)
    return t if d is None else tp_layers.all_gather_dim(t.detach(), d, plan.axis)


def slice_tensor(plan: TPPlan, name: str, t: torch.Tensor) -> torch.Tensor:
    """This rank's slice of the whole tensor ``t`` of ``name``, as a copy;
    ``t`` where ``name`` is not sharded."""
    d = plan.dims.get(name)
    return t if d is None else tp_layers.local_slice(t, d, plan.axis).clone()


def gather_tensors(tensors: Dict[str, torch.Tensor], plan: TPPlan) -> Dict[str, torch.Tensor]:
    """:func:`gather_tensor` of each named tensor, in order: collective."""
    return {n: gather_tensor(plan, n, t) for n, t in tensors.items()}


def slice_tensors(tensors: Dict[str, torch.Tensor], plan: TPPlan) -> Dict[str, torch.Tensor]:
    """:func:`slice_tensor` of each named tensor."""
    return {n: slice_tensor(plan, n, t) for n, t in tensors.items()}


def shard_bytes(model: nn.Module) -> Tuple[int, int]:
    """``(bytes of the parameters this rank holds, of those it holds a slice of)``."""
    plan = tp_plan(model)
    own = sharded = 0
    for n, p in model.named_parameters():
        b = p.numel() * p.element_size()
        own += b
        if plan is not None and n in plan.dims:
            sharded += b
    return own, sharded


def summary(model: nn.Module) -> str:
    """What a sharded model holds on this rank, for the log."""
    plan = tp_plan(model)
    own, sharded = shard_bytes(model)
    return (f"tensor-parallel over {plan.axis.size} model ranks: {len(plan.dims)} parameters and "
            f"buffers sharded, {own} bytes of parameters on this rank ({sharded} of them shards)")

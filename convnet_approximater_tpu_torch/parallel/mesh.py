"""The ``(data, model)`` mesh over the ranks (port of the data-axis half of
``convnet_approximater_tpu/parallel/mesh.py``).

The JAX package lays arrays out over a ``jax.sharding.Mesh`` in one process
and lets XLA insert the collectives.  Here each rank is one process on one
device: the mesh is a ``torch.distributed`` ``DeviceMesh`` with the same axis
names, a "sharded" batch is the rank's own rows of it, and "replicated"
weights are every rank's copy, broadcast from the data group's first rank.
:func:`param_shardings` reads the tensor-parallel rules (``parallel/tp.py``)
against the port's parameter names and gives, per parameter, the torch dim
the ``model`` axis shards (``parallel/tp.py::shard_module`` then keeps each
rank's slice).  :func:`spatial_sharding` names the layout of
``parallel/spatial.py``: the batch over ``data``, the image rows over ``model``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .distributed import process_count

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(data: Optional[int] = None, model: int = 1, device_type: Optional[str] = None):
    """A ``(data, model)`` ``DeviceMesh`` over the process group's ranks:
    rank ``d * model + m`` sits at ``(d, m)``.  ``device_type`` defaults to
    ``cuda`` on an NCCL group and ``cpu`` on gloo."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.initialize_distributed first")
    n = process_count()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"{data}x{model} mesh != {n} devices")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_ranks(mesh, axis: str):
    """``(index of this rank along axis, the axis's size, the axis's group,
    the global rank of each index)``."""
    group = mesh.get_group(axis)
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    return (mesh.get_local_rank(axis), size, group,
            [dist.get_global_rank(group, i) for i in range(size)])


def batch_sharding(mesh) -> Tuple[int, int]:
    """``(index, count)``: this rank's place on the data axis, the part of
    every global batch it holds (the ``Loader``'s ``sharding=``)."""
    index, count, _, _ = axis_ranks(mesh, DATA_AXIS)
    return index, count


class SpatialSharding(NamedTuple):
    """The layout of :func:`spatial_sharding`: an NCHW batch with its rows
    (the leading axis) over ``spec[0]`` and its image rows over ``spec[1]``."""

    mesh: object
    spec: Tuple[str, str] = (DATA_AXIS, MODEL_AXIS)


def spatial_sharding(mesh) -> SpatialSharding:
    """The batch over the mesh's ``data`` axis and the image rows over its
    ``model`` axis (JAX ``NamedSharding(mesh, P("data", "model"))`` on NHWC).
    ``parallel/spatial.py`` lays a batch (``shard_spatial``) and a model
    (``spatial_module``) out so; ``mesh`` None is one process holding it all."""
    return SpatialSharding(mesh)


def shard_rows(n: int, sharding: Tuple[int, int]) -> slice:
    """The contiguous rows of ``n`` that ``sharding`` holds; ``n`` must split evenly."""
    index, count = sharding
    if n % count:
        raise ValueError(f"a batch of {n} rows does not split over {count} data ranks")
    per = n // count
    return slice(index * per, (index + 1) * per)


def pad_indices(idx: np.ndarray, count: int) -> np.ndarray:
    """The batch ``idx`` tiled up to the next multiple of ``count`` rows, its
    rows repeated from the start, as ``deploy.pad_batch_to_multiple`` tiles a batch."""
    return idx[np.arange(-(-len(idx) // count) * count) % len(idx)]


def shard_indices(idx: np.ndarray, sharding: Tuple[int, int], pad: bool = False) -> np.ndarray:
    """The rows of the global batch ``idx`` that ``sharding`` holds.  With
    ``pad``, a batch that does not split evenly is first tiled up to the next
    multiple of the ranks (:func:`pad_indices`); without, it must split evenly."""
    if pad:
        idx = pad_indices(idx, sharding[1])
    return idx[shard_rows(len(idx), sharding)]


def shard_batch(batch, mesh):
    """This rank's contiguous slice of the leading axis of ``batch`` (a tensor,
    or a tuple or list of them) over the data axis."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, mesh) for b in batch)
    return batch[shard_rows(batch.shape[0], batch_sharding(mesh))]


def replicate(module: nn.Module, mesh) -> nn.Module:
    """Every rank of a data group takes the parameters and buffers of the
    group's first rank."""
    _, count, group, ranks = axis_ranks(mesh, DATA_AXIS)
    if count > 1:
        broadcast_module(module, group, ranks[0])
    return module


@torch.no_grad()
def broadcast_module(module: nn.Module, group, src: int) -> None:
    """Copy global rank ``src``'s parameters and buffers into every rank of
    ``group`` (a copy into each tensor, so the kernel layers' caches, keyed on
    weight versions, see the change)."""
    for t in list(module.parameters()) + list(module.buffers()):
        incoming = t.detach().contiguous().clone()  # collectives take dense tensors
        dist.broadcast(incoming, src=src, group=group)
        t.copy_(incoming)


def jax_path(name: str, ndim: int) -> str:
    """The JAX package's ``/``-joined param path of the port's parameter
    ``name`` (``convert.params_to_jax``'s naming: a norm's 1-d ``weight`` is
    ``scale``)."""
    *prefix, leaf = name.split(".")
    if leaf == "weight" and ndim == 1:
        leaf = "scale"
    return "/".join(prefix + [leaf])


def torch_dim(name: str, ndim: int, jax_dim: int) -> int:
    """The port's dim of a parameter's JAX dim ``jax_dim``: a conv ``weight``
    (or ``weight_q``) is HWIO there and OIHW here (JAX 3 -> 0, 2 -> 1, 0 -> 2,
    1 -> 3), a ``Linear`` one ``(in, out)`` there and ``(out, in)`` here; every
    other leaf keeps its dims."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("weight", "weight_q") and ndim == 4:
        return (2, 3, 1, 0)[jax_dim]
    if leaf in ("weight", "weight_q") and ndim == 2:
        return 1 - jax_dim
    return jax_dim


def _model_dim(name: str, shape, spec) -> Optional[int]:
    """The torch dim that ``spec`` (a JAX ``PartitionSpec`` as a tuple of axis
    names, tuples of them or None) shards over the model axis, or None.  Other
    axes (a rule may name the data axis) leave a parameter replicated here."""
    spec = tuple(spec)
    if len(spec) > len(shape):
        raise ValueError(f"param_shardings: spec {spec} of {name} has more entries than its "
                         f"{len(shape)} dims")
    dims = [j for j, axes in enumerate(spec)
            if axes == MODEL_AXIS or (isinstance(axes, (tuple, list)) and MODEL_AXIS in axes)]
    if len(dims) > 1:
        raise ValueError(f"param_shardings: spec {spec} of {name} names the model axis twice")
    return torch_dim(name, len(shape), dims[0]) if dims else None


def param_shardings(params: Union[nn.Module, Dict[str, torch.Tensor]], mesh=None,
                    tp_rules: Sequence[tuple] = (), warn: bool = True
                    ) -> Dict[str, Optional[int]]:
    """Port of the JAX ``param_shardings``: per parameter of ``params`` (a
    module, or a ``{name: tensor}`` dict of the port's names), the torch dim
    that the ``model`` axis shards, or None (replicated).

    The rules ``(path_suffix, spec)`` are the JAX package's: matched against
    the parameter's JAX path (:func:`jax_path`: the port's name with ``/`` for
    ``.``), ``spec`` in the JAX layout (:func:`torch_dim` translates it).  A
    ``^``-prefixed suffix matches the full path only; a ``?`` prefix (before
    any ``^``) marks a rule optional, left out of the unmatched warning; the
    first matching rule wins.  A non-optional rule that matches nothing logs
    ``tp rules matched no params (typo?)``, unless its dense ``.../weight``
    names a layer whose ``.../weight_q`` twin matched (an int8 tree), or
    ``warn`` is off (deploy-rewritten trees drop params the preset names).
    ``mesh`` is unused: the dims do not depend on the axis's size."""
    from convnet_approximater_tpu_torch.utils.logger import get_logger

    named = dict(params.named_parameters()) if isinstance(params, nn.Module) else dict(params)
    tp_rules = list(tp_rules)
    used = [False] * len(tp_rules)
    stripped = [(s[1:] if s.startswith("?") else s, s.startswith("?")) for s, _ in tp_rules]
    out = {}
    for name, t in named.items():
        key = jax_path(name, t.dim())
        out[name] = None
        for i, (suffix, _opt) in enumerate(stripped):
            if key == suffix[1:] if suffix.startswith("^") else key.endswith(suffix):
                out[name] = _model_dim(name, t.shape, tp_rules[i][1])
                used[i] = True
                break
    matched = {stripped[i][0] for i, u in enumerate(used) if u}
    unmatched = [
        tp_rules[i][0] for i, u in enumerate(used)
        if not u and not stripped[i][1]
        and not (stripped[i][0].endswith("/weight")
                 and stripped[i][0][:-len("/weight")] + "/weight_q" in matched)]
    if warn and unmatched:
        get_logger().warning(f"param_shardings: tp rules matched no params (typo?): {unmatched}")
    return out


def pad_to_multiple(batch, multiple: int):
    """Pad the leading axis with zeros up to a multiple of ``multiple`` (to
    split evenly); returns ``(padded, valid_count)``."""
    n = batch.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return batch, n
    if isinstance(batch, torch.Tensor):
        pad = torch.zeros((rem,) + tuple(batch.shape[1:]), dtype=batch.dtype, device=batch.device)
        return torch.cat([batch, pad]), n
    pad = [(0, rem)] + [(0, 0)] * (batch.ndim - 1)
    return np.pad(np.asarray(batch), pad), n

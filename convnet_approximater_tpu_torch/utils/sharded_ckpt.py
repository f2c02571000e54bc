"""Sharded, asynchronous checkpoints on ``torch.distributed.checkpoint``
(port of ``convnet_approximater_tpu/utils/sharded_ckpt.py``).

A checkpoint is a directory ``<name>.ckpt.dcp`` that DCP writes: the tree's
leaves under their flat ``/``-joined keys (the npz checkpoints' key space),
tensors in DCP's storage files, Python scalars (``meta/epoch``,
``meta/metric``) pickled beside them.  Without a process group DCP writes
and reads it from this process alone (it warns once that it assumes so).

* :func:`save_sharded` with ``wait=False`` is ``dcp.async_save``: the call
  brings the tree's leaves to host memory (a card tensor is copied; host
  arrays are handed over, not copied again: DCP's own staging copy cost as
  much as an npz save) and returns; a thread writes the files.  The save in
  flight is held until the next save or :func:`wait_for_saves`, one at a
  time, as the JAX module holds orbax's.
* :func:`restore_sharded` without a target returns the tree as host numpy,
  as the JAX one does; with a target (:func:`abstract_like`: tensors already
  placed where the restore should land them) DCP reads into those tensors.
* Across processes the save is collective: every rank calls it with the same
  tree and the same ``group`` (:func:`checkpoint_group`, a gloo group: DCP's
  asynchronous save coordinates over a CPU backend, and a group of its own
  keeps its background collectives apart from the trainers'); the group's
  first rank clears the old directory behind a barrier, as the JAX module's
  ``sync_global_devices("sharded_ckpt_pre_save")`` does, and DCP writes each
  replicated tensor once.  A checkpoint written at one world size restores at
  any other, in one process too.
* A JAX ``.oshard`` directory holds orbax/TensorStore data, which this port
  does not read: it is refused with the way across (the JAX ``load_ckpt``,
  then ``save_model`` to npz).
"""

from __future__ import annotations

import functools
import os
import shutil
import threading
from concurrent.futures import Future
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .serialize import flatten_tree, unflatten_tree

SHARDED_SUFFIX = ".dcp"
JAX_SHARDED_SUFFIX = ".oshard"

_lock = threading.Lock()
_in_flight: Optional[Future] = None


def is_sharded_ckpt(path: str) -> bool:
    """Whether ``path`` names a sharded checkpoint directory (the port's, or
    a JAX ``.oshard`` one, which :func:`restore_sharded` refuses)."""
    return str(path).rstrip("/").endswith((SHARDED_SUFFIX, JAX_SHARDED_SUFFIX))


def _check_ours(path: str) -> None:
    if str(path).rstrip("/").endswith(JAX_SHARDED_SUFFIX):
        raise ValueError(
            f"{path}: a JAX orbax/TensorStore checkpoint, which the port does not read; "
            f"convert it where the JAX package runs: convnet_approximater_tpu.utils."
            f"serialize.load_ckpt, then save_model to a .ckpt.npz, which the port reads")
    if not str(path).rstrip("/").endswith(SHARDED_SUFFIX):
        raise ValueError(f"{path}: a sharded checkpoint's name ends in {SHARDED_SUFFIX}")


def _to_tensor(v):
    """A leaf as DCP stores it: arrays and numpy scalars as host tensors that
    share their memory (a bfloat16 array through its bits), tensors detached
    (on the host), Python values as they are."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    if isinstance(v, (np.ndarray, np.generic)):
        a = np.asarray(v)
        a = a if a.flags.c_contiguous else a.copy()  # (ascontiguousarray makes 0-d 1-d)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)
    return v


def _to_numpy(v):
    if not isinstance(v, torch.Tensor):
        return v
    if v.dtype == torch.bfloat16:
        import ml_dtypes  # numpy has no bfloat16 of its own

        return v.cpu().view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return v.cpu().numpy()


@functools.cache
def _handed_over():
    """A DCP stager that stages nothing: :func:`save_sharded`'s leaves are host
    tensors that the caller hands over."""
    from torch.distributed.checkpoint.staging import AsyncStager

    class HandedOver(AsyncStager):
        _synchronize_after_execute = False

        def stage(self, state_dict):
            return state_dict

        def synchronize_staging(self):
            pass

        def close(self):
            pass

    return HandedOver


def wait_for_saves() -> None:
    """Block until an asynchronous :func:`save_sharded` has committed; raise
    what it raised."""
    global _in_flight
    with _lock:
        pending, _in_flight = _in_flight, None
    if pending is not None:
        pending.result()


def checkpoint_group():
    """A gloo group over every rank for :func:`save_sharded`, or None outside a
    process group.  Collective: every rank makes it together."""
    return dist.new_group(backend="gloo") if dist.is_initialized() else None


def save_sharded(path: str, tree: Dict[str, Any], *, wait: bool = True, group=None) -> str:
    """Save a nested tree of tensors, numpy arrays and Python scalars to the
    directory ``path`` (which must end in ``.dcp``), replacing what was there.

    With ``wait=False`` a thread writes the tree after the call returns: its
    host arrays are handed over, and the caller leaves them unchanged until
    the save commits (:class:`~convnet_approximater_tpu_torch.hooks.finetune.CheckpointSaver`
    builds a fresh host copy of the train state for each save);
    :func:`wait_for_saves`, the next save or a restore waits for it.  With a
    ``group`` (:func:`checkpoint_group`) the save is collective over it."""
    import torch.distributed.checkpoint as dcp

    global _in_flight
    _check_ours(path)
    path = os.path.abspath(path)
    wait_for_saves()  # one save in flight at a time
    if group is None or dist.get_rank(group) == 0:
        if os.path.islink(path):
            os.remove(path)
        elif os.path.exists(path):
            shutil.rmtree(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if group is not None:
        dist.barrier(group=group)  # no rank writes before the old directory is gone
    state = {k: _to_tensor(v) for k, v in flatten_tree(tree).items()}
    if wait:
        dcp.save(state, checkpoint_id=path, process_group=group)
        return path
    future = dcp.async_save(state, checkpoint_id=path, async_stager=_handed_over()(),
                            process_group=group)
    # torch's newer releases may hand back a response that holds the upload's future
    future = getattr(future, "upload_completion", future)
    with _lock:
        _in_flight = future
    return path


def abstract_like(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The restore target of a tree shaped like ``tree``: an empty tensor of
    each leaf's shape and type on ``device`` (by default the leaf's own, or
    the CPU for a numpy leaf), into which :func:`restore_sharded` reads;
    Python scalars pass through and come back as saved."""

    def leaf(v):
        t = v if isinstance(v, torch.Tensor) else _to_tensor(v)
        if not isinstance(t, torch.Tensor):
            return v
        return torch.empty_like(t, device=device if device is not None else t.device)

    return unflatten_tree({k: leaf(v) for k, v in flatten_tree(tree).items()})


def restore_sharded(path: str, target: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Restore a :func:`save_sharded` checkpoint: into ``target``'s tensors
    (see :func:`abstract_like`), returned as the target tree with its scalars
    as saved; without a target, the whole tree as host numpy arrays and
    Python scalars.  In a process group the read is collective over every rank."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    _check_ours(path)
    path = os.path.abspath(path)
    wait_for_saves()
    if not os.path.isfile(os.path.join(path, ".metadata")):
        raise FileNotFoundError(f"{path}: no sharded checkpoint (no .metadata) there")
    if target is not None:
        state = flatten_tree(target)
    else:
        meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
        state = {k: torch.empty(m.size, dtype=m.properties.dtype)
                 if isinstance(m, TensorStorageMetadata) else None for k, m in meta.items()}
    dcp.load(state, checkpoint_id=path)
    if target is not None:
        return unflatten_tree(state)
    return unflatten_tree({k: _to_numpy(v) for k, v in state.items()})

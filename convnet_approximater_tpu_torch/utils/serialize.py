"""Flat ``/``-joined npz checkpoints (port of ``convnet_approximater_tpu/utils/serialize.py``).

A checkpoint is one ``.npz`` of flat ``/``-joined keys over a nested tree of
numpy arrays (the JAX package's ``{'params': ..., 'state': ...}``).  Dtypes that
npz cannot hold (bfloat16, float8) are stored bit-cast to a same-width integer
under a ``<key>::<dtype>`` name and viewed back at load.  :func:`load_flat` and
:func:`load_ckpt` also read a sharded ``.ckpt.dcp`` directory
(``utils/sharded_ckpt.py``), as the JAX ``load_ckpt`` reads its ``.oshard``
ones.  :func:`tree_get` /
:func:`tree_set` address subtrees by dotted path.
"""

from __future__ import annotations

import io
import os
from typing import Any, Dict

import numpy as np

SEP = "/"

_EXOTIC_DTYPES = {
    "bfloat16": np.uint16,
    "float8_e4m3fn": np.uint8,
    "float8_e5m2": np.uint8,
}
_DTYPE_MARK = "::"


def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        elif v is not None:
            out[key] = v
    return out


def unflatten_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_model(variables: Dict[str, Any], path: str):
    """Save a nested tree of arrays to ``path`` as one flat-key ``.npz``."""
    marked = {}
    for k, v in flatten_tree(variables).items():
        if _DTYPE_MARK in k:
            raise ValueError(f"param key {k!r} contains the reserved dtype marker "
                             f"{_DTYPE_MARK!r}; rename the module/param")
        v = np.asarray(v)
        name = v.dtype.name
        if name in _EXOTIC_DTYPES:
            marked[f"{k}{_DTYPE_MARK}{name}"] = v.view(_EXOTIC_DTYPES[name])
        else:
            marked[k] = v
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, **marked)
    tmp = path + ".tmp"  # written whole, then renamed: an interrupted run leaves no half file
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def load_flat(path: str) -> Dict[str, np.ndarray]:
    """Load a checkpoint (an ``.npz`` file, or a sharded ``.ckpt.dcp`` directory of
    ``utils/sharded_ckpt.py``) as its flat ``/``-joined key -> array dict."""
    from .sharded_ckpt import is_sharded_ckpt, restore_sharded

    if is_sharded_ckpt(path):
        return flatten_tree(restore_sharded(path))
    flat = {}
    with np.load(path, allow_pickle=False) as data:
        for k in data.files:
            key, _, dname = k.rpartition(_DTYPE_MARK)
            if key and dname in _EXOTIC_DTYPES:
                import ml_dtypes

                flat[key] = data[k].view(getattr(ml_dtypes, dname))
            else:
                flat[k] = data[k]
    return flat


def load_ckpt(path: str) -> Dict[str, Any]:
    """Load a checkpoint (``.npz`` or sharded ``.ckpt.dcp``) into a nested numpy tree."""
    return unflatten_tree(load_flat(path))


def tree_get(tree: Dict[str, Any], path: str):
    """Fetch a subtree/leaf by dotted path ('' returns the tree itself)."""
    if not path:
        return tree
    node = tree
    for p in path.split("."):
        node = node[p]
    return node


def tree_set(tree: Dict[str, Any], path: str, value) -> None:
    """Set a subtree/leaf by dotted path, in place."""
    parts = path.split(".")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value

"""Carry weights between the JAX package and the port.

:func:`params_from_jax` turns a flat ``{'params': ..., 'state': ...}`` tree of
the JAX package (keys ``/``-joined, as :func:`~.utils.serialize.flatten_tree`
and its ``.npz`` checkpoints write them) into a ``state_dict`` of the port,
whose dotted names equal the JAX param paths.  The layouts differ only at the
leaves:

* conv weight HWIO ``(kh, kw, in/groups, out)`` -> OIHW, and so the int8
  ``weight_q`` of ``QuantConv2d``;
* ``Linear`` weight ``(in, out)`` -> ``(out, in)``, and so ``QuantLinear``'s
  ``weight_q``;
* BatchNorm/LayerNorm/GroupNorm ``scale`` -> ``weight`` (``bias`` keeps its name);
* BatchNorm state ``mean``/``var`` -> ``running_mean``/``running_var``;
* the QAT twins' observer, state ``act_absmax`` (a 0-d buffer), keeps its name;
* the Hamburger's NMF dictionary start, state ``nmf_init`` (1, C, rank), keeps
  its name: the JAX package draws it inside the forward from a fixed
  ``jax.random`` key and stores none, so a JAX checkpoint leaves the port's own
  draw in place, and a test that holds the port against JAX adds JAX's draw
  under that key;
* everything else (``FixPaddingBias.res`` (2, C, p), ``FixPaddingBias2d``'s
  ``res_v``/``res_h`` (2, C, p) and ``res_c`` (2, 2, C, p, p),
  ``layer_scale_*``, ConvNeXt's ``gamma``, the quantized modules' ``w_scale``
  and 0-d ``act_scale``) as is.

This is the inverse direction of ``scripts/ckpt_converter/torch_to_tpu.py``'s
``convert_conv``/``convert_linear``.  :func:`params_to_jax` is the inverse of
:func:`params_from_jax`, so the port writes its checkpoints in the JAX
package's flat ``/``-joined npz layout, and :func:`load_jax_flat` loads either
package's into a port model.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from convnet_approximater_tpu_torch.utils.logger import get_logger
from convnet_approximater_tpu_torch.utils.serialize import unflatten_tree

_STATE_NAMES = {"mean": "running_mean", "var": "running_var"}


def _leaf(collection: str, name: str, v: np.ndarray):
    if collection == "state":
        return _STATE_NAMES.get(name, name), v
    if name in ("weight", "weight_q") and v.ndim == 4:
        return name, np.transpose(v, (3, 2, 0, 1))
    if name in ("weight", "weight_q") and v.ndim == 2:
        return name, np.transpose(v, (1, 0))
    if name == "scale":
        return "weight", v
    return name, v


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX ``params/...`` and ``state/...`` leaves -> the port's ``state_dict``."""
    out = {}
    for key, v in flat.items():
        collection, _, path = key.partition("/")
        if collection not in ("params", "state") or not path:
            raise ValueError(f"expected a 'params/...' or 'state/...' key, got {key!r}")
        *prefix, name = path.split("/")
        name, v = _leaf(collection, name, np.asarray(v))
        out[".".join(prefix + [name])] = torch.tensor(v)
    return out


def params_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's ``state_dict`` -> JAX ``params/...`` and ``state/...`` leaves
    (OIHW -> HWIO, ``(out, in)`` -> ``(in, out)``, a norm's 1-d ``weight`` ->
    ``scale``, ``running_mean``/``running_var`` -> state ``mean``/``var``, a QAT
    twin's ``act_absmax`` and the Hamburger's ``nmf_init`` -> state leaves of
    those names)."""
    out = {}
    for key, t in state_dict.items():
        *prefix, name = key.split(".")
        v = t.detach().cpu().numpy()
        collection = "params"
        if name in ("running_mean", "running_var"):
            collection, name = "state", name[len("running_"):]
        elif name in ("act_absmax", "nmf_init"):
            collection = "state"
        elif name in ("weight", "weight_q") and v.ndim == 4:
            v = np.transpose(v, (2, 3, 1, 0))
        elif name in ("weight", "weight_q") and v.ndim == 2:
            v = np.transpose(v, (1, 0))
        elif name == "weight" and v.ndim == 1:
            name = "scale"
        out["/".join([collection] + prefix + [name])] = np.ascontiguousarray(v).copy()
    return out


def variables_of(model: nn.Module) -> dict:
    """``{'params': ..., 'state': ...}`` of ``model`` in the JAX package's
    layout, as nested numpy trees (what its ``save_model`` writes)."""
    return unflatten_tree(params_to_jax(model.state_dict()))


def load_jax_flat(model: nn.Module, flat: Dict[str, np.ndarray]):
    """Load the ``params/...`` and ``state/...`` leaves of a flat checkpoint
    tree into ``model``, non-strict: a leaf of another shape is skipped with
    a warning, and missing and unexpected keys are logged (the JAX package's
    ``load_into``).  Other collections (``opt``, ``meta``) are ignored."""
    logger = get_logger()
    state = params_from_jax({k: v for k, v in flat.items()
                             if k.split("/", 1)[0] in ("params", "state")})
    own = model.state_dict()
    for k in sorted(set(state) & set(own)):
        if state[k].shape != own[k].shape:
            logger.warning(f"shape mismatch for {k}: ckpt {tuple(state[k].shape)} "
                           f"vs model {tuple(own[k].shape)}; skipped")
            del state[k]
    missing, unexpected = model.load_state_dict(state, strict=False)
    if missing:
        logger.warning(f"missing keys in checkpoint: {missing}")
    if unexpected:
        logger.warning(f"unexpected keys in checkpoint: {unexpected}")

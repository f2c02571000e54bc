"""Carry the JAX package's weights across to the port.

:func:`params_from_jax` turns a flat ``{'params': ..., 'state': ...}`` tree of
the JAX package (keys ``/``-joined, as :func:`~.utils.serialize.flatten_tree`
and its ``.npz`` checkpoints write them) into a ``state_dict`` of the port,
whose dotted names equal the JAX param paths.  The layouts differ only at the
leaves:

* conv weight HWIO ``(kh, kw, in/groups, out)`` -> OIHW, and so the int8
  ``weight_q`` of ``QuantConv2d``;
* ``Linear`` weight ``(in, out)`` -> ``(out, in)``, and so ``QuantLinear``'s
  ``weight_q``;
* BatchNorm/LayerNorm ``scale`` -> ``weight`` (``bias`` keeps its name);
* BatchNorm state ``mean``/``var`` -> ``running_mean``/``running_var``;
* everything else (``FixPaddingBias.res`` (2, C, p), ``FixPaddingBias2d``'s
  ``res_v``/``res_h`` (2, C, p) and ``res_c`` (2, 2, C, p, p),
  ``layer_scale_*``, ConvNeXt's ``gamma``, the quantized modules' ``w_scale``
  and 0-d ``act_scale``) as is.

This is the inverse direction of ``scripts/ckpt_converter/torch_to_tpu.py``'s
``convert_conv``/``convert_linear``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

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

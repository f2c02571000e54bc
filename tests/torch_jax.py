"""Helpers shared by the port's parity tests."""

import numpy as np


def jax_tree(module) -> dict:
    """The JAX package's ``{"params": ..., "state": ...}`` flat tree of a port
    module's ``state_dict``: the inverse of ``convert.params_from_jax`` (OIHW
    -> HWIO, (out, in) -> (in, out), a norm's 1-d ``weight`` -> ``scale``,
    ``running_mean``/``running_var`` -> state ``mean``/``var``).  Lets a test
    draw the weights once, in the port, and hand the same values to both."""
    flat = {}
    for key, t in module.state_dict().items():
        *prefix, name = key.split(".")
        v = t.detach().cpu().numpy().copy()  # not a view of the module's tensor
        collection = "params"
        if name in ("running_mean", "running_var"):
            collection, name = "state", name[len("running_"):]
        elif name in ("weight", "weight_q") and v.ndim == 4:
            v = np.transpose(v, (2, 3, 1, 0))
        elif name in ("weight", "weight_q") and v.ndim == 2:
            v = np.transpose(v, (1, 0))
        elif name == "weight" and v.ndim == 1:
            name = "scale"
        flat["/".join([collection] + prefix + [name])] = np.ascontiguousarray(v)
    return flat

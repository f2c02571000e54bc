"""Name -> class registries with config-driven construction.

Port of ``convnet_approximater_tpu/utils/registry.py``: the same surface
(``Registry.register_module`` / ``Registry.get`` / ``build_from_cfg`` accepting
str / dict / list / None).  A list config builds a ``torch.nn.Sequential`` of
the built modules.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

# names the JAX package registers and the port does not have yet -> the
# ROADMAP.md queue 1 item that ports them (none since SegNeXt was ported)
PENDING: Dict[str, int] = {}


class Registry:
    """A simple name -> class map."""

    def __init__(self, name: str = ""):
        self.name = name
        self._modules: Dict[str, Any] = {}

    def register_module(self, name: Optional[str] = None, module: Any = None):
        def _register(module):
            key = name if name is not None else module.__name__
            if key in self._modules:
                raise KeyError(f"{key} is already registered in registry {self.name!r}.")
            self._modules[key] = module
            return module

        if module is not None:
            return _register(module)
        return _register

    def get(self, name: str):
        if name not in self._modules and name in PENDING:
            raise NotImplementedError(
                f"{name} ({self.name!r} registry) is not ported to the PyTorch port yet "
                f"(ROADMAP.md queue 1 item {PENDING[name]})")
        if name not in self._modules:
            raise KeyError(
                f"{name} is not registered in registry {self.name!r} of the PyTorch port. "
                f"Available: {sorted(self._modules)}"
            )
        return self._modules[name]

    def __contains__(self, name: str) -> bool:
        return name in self._modules

    def keys(self):
        return self._modules.keys()


def build_from_cfg(cfg, registry: Registry, **kwargs):
    """Build an object from a config.

    ``cfg`` may be:
      * a ``str`` -- registry name, built with only ``**kwargs``;
      * a ``dict`` -- must contain ``type`` (name or class), remaining keys are
        constructor kwargs (``kwargs`` override);
      * a ``list`` -- each element built recursively, wrapped in a Sequential;
      * ``None`` -- returns ``None``.
    """
    if cfg is None:
        return None
    if isinstance(cfg, str):
        return registry.get(cfg)(**kwargs)
    if isinstance(cfg, dict):
        args = dict(cfg)
        args.update(kwargs)
        obj_type = args.pop("type")
        obj_cls = obj_type if isinstance(obj_type, type) else registry.get(obj_type)
        try:
            return obj_cls(**args)
        except TypeError as e:
            raise TypeError(f"{obj_cls.__name__}: {e}") from e
    if isinstance(cfg, (list, tuple)):
        import torch

        return torch.nn.Sequential(*[build_from_cfg(c, registry, **kwargs) for c in cfg])
    raise TypeError(f"config type {type(cfg)} not supported")

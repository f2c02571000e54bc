"""The model side of the substitution engine (port of
``convnet_approximater_tpu/models/switchable.py``).

``register_switchable`` walks ``named_children`` breadth first, in exactly the
reference's order: a FIFO queue seeded with the model's direct children, and
a match is not recursed into.  ``freeze_except`` / ``unfreeze`` give the set
of trainable parameter names, where the JAX package gives a mask tree.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Set

from torch import nn

from convnet_approximater_tpu_torch.utils.logger import get_logger
from convnet_approximater_tpu_torch.utils.registry import Registry, build_from_cfg


def set_submodule(root: nn.Module, path: str, module: nn.Module):
    """Replace the submodule at dotted ``path`` with ``module``."""
    parent_path, _, name = path.rpartition(".")
    parent = root.get_submodule(parent_path)
    if name not in parent._modules:
        raise AttributeError(f"{type(parent).__name__} has no submodule {name!r}")
    setattr(parent, name, module)


class SwitchableModel(nn.Module):
    def __init__(self, init_cfg: Optional[str] = None):
        super().__init__()
        self._switchable_names: List[str] = []
        self.init_cfg = init_cfg

    def load_init_cfg(self):
        """Load the JAX package's ``.npz`` checkpoint named by ``init_cfg`` (non-strict)."""
        if not isinstance(self.init_cfg, str):
            return
        from convnet_approximater_tpu_torch.convert import load_jax_flat
        from convnet_approximater_tpu_torch.utils.serialize import load_flat

        get_logger().info(f"loading checkpoint from {self.init_cfg}")
        load_jax_flat(self, load_flat(self.init_cfg))

    def register_switchable(self, src_type: type, filters, verbose: bool = False):
        """BFS over named children; matching modules pass the filter chain."""
        self._switchable_names = []
        queue = list(self.named_children())
        while queue:
            name, module = queue.pop(0)
            if isinstance(module, src_type):
                passed = True
                for f in filters:
                    if not f(module):
                        passed = False
                        if verbose:
                            get_logger().info(f"{name} filtered out by {type(f).__name__}")
                        break
                if passed:
                    self._switchable_names.append(name)
                continue
            for child_name, child in module.named_children():
                queue.append((f"{name}.{child_name}", child))

    @property
    def length_switchable(self) -> int:
        return len(self._switchable_names)

    @property
    def switchable_names(self) -> List[str]:
        return list(self._switchable_names)

    def get_switchable_module(self, index: int) -> nn.Module:
        return self.get_submodule(self._switchable_names[index])

    def set_switchable_module(self, index: int, module: nn.Module):
        set_submodule(self, self._switchable_names[index], module)

    def switchable_modules(self) -> Iterator[nn.Module]:
        for idx in range(self.length_switchable):
            yield self.get_switchable_module(idx)

    # -- freeze masks ----------------------------------------------------
    def freeze_except(self, *indices: int) -> Set[str]:
        """Names of the trainable parameters: those under the listed
        switchables, every other one frozen.  Where the module at a listed
        path defines ``switchable_layer()`` (MSCA -> ``sd_convs``), only that
        submodule is trainable (the JAX package's mask, ``switchable.py:95-119``)."""
        targets = []
        for index in indices:
            name = self._switchable_names[index]
            module = self.get_submodule(name)
            if hasattr(module, "switchable_layer"):
                name = f"{name}.{module.switchable_layer()}"
            targets.append(name)
        return {n for n, _ in self.named_parameters()
                if any(n.startswith(t + ".") for t in targets)}

    def unfreeze(self) -> Set[str]:
        return {n for n, _ in self.named_parameters()}


MODEL = Registry("MODEL")


def build_model(cfg) -> SwitchableModel:
    return build_from_cfg(cfg, MODEL)

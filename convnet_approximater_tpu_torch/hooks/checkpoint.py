"""Declarative stage-level checkpointing (port of
``convnet_approximater_tpu/hooks/checkpoint.py``): ``ckpt_cfg = {stage:
{action: 'save'|'load', path: ...}}`` saves or loads the runner's model at a
lifecycle stage, for example to load an optimized checkpoint after Initialize
and skip the solve; across processes only the main process saves.
Checkpoints are the JAX package's flat npz layout
(:func:`~convnet_approximater_tpu_torch.convert.params_to_jax`), so either
package loads the other's.  Before Initialize the model has no weights yet,
so a ``before_run`` or ``after_register`` entry does nothing, as in the JAX
package.
"""

from __future__ import annotations

import os

from convnet_approximater_tpu_torch.convert import load_jax_flat, variables_of
from convnet_approximater_tpu_torch.parallel.distributed import is_main_process
from convnet_approximater_tpu_torch.utils import get_logger, load_flat, save_model

from .hook import HOOK, Hook


def save_model_ckpt(model, path: str):
    """Write ``model``'s weights to ``path`` in the JAX package's npz layout
    (the main process only, across processes)."""
    if is_main_process():
        save_model(variables_of(model), path)


def load_model_ckpt(model, path: str):
    """Load a checkpoint of either package into ``model``, non-strict."""
    get_logger().info(f"loading checkpoint from {path}")
    load_jax_flat(model, load_flat(path))


@HOOK.register_module()
class CkptHook(Hook):
    def __init__(self, runner, priority, ckpt_cfg):
        super().__init__(runner, priority)
        self.ckpt_cfg = {}
        for stage in self.stages:
            cur = ckpt_cfg.get(stage)
            if cur is not None:
                if cur["action"] not in ("save", "load"):
                    raise ValueError(f"CkptHook {stage}: action must be 'save' or 'load', "
                                     f"got {cur['action']!r}")
                if cur["action"] == "load" and not os.path.isfile(cur["path"]):
                    raise FileNotFoundError(f"CkptHook {stage}: no checkpoint at {cur['path']}")
            self.ckpt_cfg[stage] = cur

    def _save_or_load(self, cfg):
        if cfg is None:
            return
        if cfg["action"] == "save":
            save_model_ckpt(self.runner.model, cfg["path"])
        else:
            load_model_ckpt(self.runner.model, cfg["path"])

    def after_initialize(self):
        self._save_or_load(self.ckpt_cfg["after_initialize"])

    def after_optimize(self):
        self._save_or_load(self.ckpt_cfg["after_optimize"])

    def after_run(self):
        self._save_or_load(self.ckpt_cfg["after_run"])

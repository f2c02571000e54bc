"""Hook lifecycle base and registry (port of ``convnet_approximater_tpu/hooks/hook.py``).

Five stages bracket the pipeline phases: ``before_run``, ``after_register``,
``after_initialize``, ``after_optimize``, ``after_run``.
"""

from __future__ import annotations

from convnet_approximater_tpu_torch.utils.registry import Registry, build_from_cfg

from .priority import get_priority


class Hook:
    stages = (
        "before_run",
        "after_register",
        "after_initialize",
        "after_optimize",
        "after_run",
    )

    def __init__(self, runner, priority):
        self.runner = runner
        self._priority = get_priority(priority)

    @property
    def name(self) -> str:
        return self.__class__.__name__

    @property
    def priority(self) -> int:
        return self._priority

    def before_run(self):
        pass

    def after_register(self):
        pass

    def after_initialize(self):
        pass

    def after_optimize(self):
        pass

    def after_run(self):
        pass


HOOK = Registry("HOOK")


def build_hook(cfg, **kwargs) -> Hook:
    return build_from_cfg(cfg, HOOK, **kwargs)

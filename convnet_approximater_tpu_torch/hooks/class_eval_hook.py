"""Classification evaluation hook (port of
``convnet_approximater_tpu/hooks/class_eval_hook.py``): validates the
runner's model at ``after_run``."""

from __future__ import annotations

from convnet_approximater_tpu_torch.classification import ValidateHelper
from convnet_approximater_tpu_torch.utils.logger import get_logger

from .hook import HOOK, Hook


@HOOK.register_module()
class ClassEvalHook(Hook):
    def __init__(self, runner, priority, eval_cfg):
        super().__init__(runner, priority)
        self.helper = ValidateHelper(runner, eval_cfg)

    def after_run(self):
        self.result = self.helper.validate()
        get_logger().info(f"eval results: {self.result}")

"""PrepareQAT: run the fine-tune phase under int8 fake-quant numerics (port of
``convnet_approximater_tpu/hooks/qat.py``).

At ``after_optimize``, ahead of ``L2Reconstruct`` (priority below 50), it swaps
the model's dense convs and Linears for their fake-quant twins
(``deploy.prepare_qat``), so the recovery trains the weights under int8
serving numerics.  Modules inside Substitution branches are left out unless
``include_substituted``: QAT covers the dense remainder, the substitutions
their own sites.  The trained model converts to its int8 serving form with
``deploy.convert_qat_to_int8``.
"""

from __future__ import annotations

from convnet_approximater_tpu_torch.deploy import prepare_qat, qat_substitution_filter
from convnet_approximater_tpu_torch.utils.logger import get_logger

from .hook import HOOK, Hook


@HOOK.register_module()
class PrepareQAT(Hook):
    def __init__(self, runner, priority, linears: bool = True, momentum: float = 0.1,
                 include_substituted: bool = False):
        super().__init__(runner, priority)
        self.linears = linears
        self.momentum = momentum
        self.include_substituted = include_substituted
        self.swapped = 0

    def after_optimize(self):
        model = self.runner.model
        filter_fn = None if self.include_substituted else qat_substitution_filter(model)
        self.swapped = prepare_qat(model, filter_fn=filter_fn, linears=self.linears,
                                   momentum=self.momentum)
        get_logger().info(f"PrepareQAT: {self.swapped} modules now train under int8 fake-quant "
                          f"(include_substituted={self.include_substituted})")

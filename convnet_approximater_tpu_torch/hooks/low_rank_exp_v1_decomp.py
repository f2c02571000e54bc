"""Post-hoc spatial factorization of every switchable scheme-1 conv (port of
``convnet_approximater_tpu/hooks/low_rank_exp_v1_decomp.py``).  Runs after
the PostProcess phase, when the switchable slots hold bare ``LowRankExpConvV1``s."""

from __future__ import annotations

import torch

from convnet_approximater_tpu_torch.layers import LowRankExpConvV1

from .hook import HOOK, Hook


@HOOK.register_module()
class LowRankExpV1Decomp(Hook):
    def after_run(self):
        model = self.runner.model
        for idx in range(model.length_switchable):
            mod = model.get_switchable_module(idx)
            if not isinstance(mod, LowRankExpConvV1):
                raise TypeError(f"switchable {model.switchable_names[idx]} is "
                                f"{type(mod).__name__}, not LowRankExpConvV1")
            mod.decomp()
        model.to(memory_format=torch.channels_last)

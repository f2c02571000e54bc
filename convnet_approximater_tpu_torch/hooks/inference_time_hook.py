"""Forward timing (port of ``convnet_approximater_tpu/hooks/inference_time_hook.py``).

The forward time is the median over ``num_iters`` forwards after ``warmup``
ones, each bracketed by CUDA events on the card, or by the host clock on the
CPU.  The JAX hook's cost-analysis line is left to ``ModelAnalysis``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from convnet_approximater_tpu_torch.utils.logger import get_logger

from .hook import HOOK, Hook


def nhwc_size(size):
    """``input_size`` as (B, H, W, C); reference configs give NCHW tuples."""
    size = tuple(size)
    if len(size) == 4 and size[1] in (1, 3) and size[3] not in (1, 3):
        size = (size[0], size[2], size[3], size[1])
    return size


def time_forward(model, input_size, device, num_iters: int = 10, warmup: int = 3):
    """Milliseconds of each of ``num_iters`` eval forwards of ``model`` on a
    (B, H, W, C) input of ones in ``channels_last``, after ``warmup`` forwards."""
    B, H, W, C = input_size
    device = torch.device(device)
    x = torch.ones(B, C, H, W, device=device).contiguous(memory_format=torch.channels_last)
    model.eval()
    times = []
    with torch.no_grad():
        for _ in range(warmup):
            model(x)
        for _ in range(num_iters):
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                model(x)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                model(x)
                times.append((time.perf_counter() - t0) * 1e3)
    return np.asarray(times)


@HOOK.register_module()
class InferenceTimeHook(Hook):
    def __init__(self, runner, priority, infer_cfg=None):
        super().__init__(runner, priority)
        infer_cfg = dict(infer_cfg or {})
        self.input_size = nhwc_size(infer_cfg.pop("input_size", (64, 224, 224, 3)))
        self.num_iters = infer_cfg.pop("num_iters", 10)
        self.warmup = max(infer_cfg.pop("warmup", 3), 1)
        if infer_cfg:
            raise NotImplementedError(
                f"InferenceTimeHook options {sorted(infer_cfg)} are not ported to the "
                f"PyTorch port yet (float32 timing only, no trace capture)")
        self.forwards = 0
        self.result = None

    def after_run(self):
        device = self.runner.device
        times = time_forward(self.runner.model, self.input_size, device, self.num_iters,
                             self.warmup)
        self.forwards = self.warmup + self.num_iters
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        med = float(np.median(times))
        get_logger().info(
            f"Forward time (batch {self.input_size[0]}): median {med:.3f} ms, "
            f"min {times.min():.3f} ms over {self.num_iters} iters on {name}")
        self.result = dict(median_ms=med, times=times, device=name)

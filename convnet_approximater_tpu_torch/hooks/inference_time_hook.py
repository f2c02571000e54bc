"""Forward timing and a profiler capture (port of
``convnet_approximater_tpu/hooks/inference_time_hook.py``).

The forward time is the median over ``num_iters`` forwards after ``warmup``
ones, each bracketed by CUDA events on the card, or by the host clock on the
CPU.  With ``capture_trace`` (or ``profile_args=dict(capture=True)``) one more
forward runs under ``torch.profiler`` after the timed ones, so the profiler's
cost never enters the median: its Chrome trace goes to ``work_dir/traces/``,
and one device-time table per ``table_args`` ``group_by`` (``op``, ``source``,
``category``; ``row_limit`` rows, without the names that hold an ``exclude``
substring) and one of the ``record_function`` ranges are logged
(``utils/trace.py``).  The JAX hook's cost-analysis line is left to
``ModelAnalysis``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from convnet_approximater_tpu_torch.utils.logger import get_logger
from convnet_approximater_tpu_torch.utils.trace import GROUPS, summarize_ranges, summarize_trace

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
        self.capture_trace = bool(infer_cfg.pop("capture_trace", False))
        profile_args = dict(infer_cfg.pop("profile_args", None) or {})
        self.capture_trace |= bool(profile_args.pop("capture", False))
        table_args = dict(infer_cfg.pop("table_args", None) or {})
        group_by = table_args.pop("group_by", GROUPS)
        self.table_group_by = (group_by,) if isinstance(group_by, str) else tuple(group_by)
        self.table_row_limit = int(table_args.pop("row_limit", 15))
        self.table_exclude = tuple(table_args.pop("exclude", ()))
        unknown = set(self.table_group_by) - set(GROUPS)
        if unknown:
            raise ValueError(f"table_args group_by {sorted(unknown)}: known are {GROUPS}")
        rest = sorted(infer_cfg) + [f"profile_args.{k}" for k in sorted(profile_args)] \
            + [f"table_args.{k}" for k in sorted(table_args)]
        if rest:
            raise NotImplementedError(
                f"InferenceTimeHook options {rest} are not ported to the PyTorch port yet "
                f"(float32 timing only: bf16 is ROADMAP.md queue 1 item 7)")
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
        if self.capture_trace:
            self.result.update(self.capture())

    def capture(self) -> dict:
        """One eval forward under ``torch.profiler`` (with Python stacks): its
        Chrome trace under ``work_dir/traces/`` and the logged tables."""
        logger = get_logger()
        device = self.runner.device
        B, H, W, C = self.input_size
        x = torch.ones(B, C, H, W, device=device).contiguous(memory_format=torch.channels_last)
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        model = self.runner.model.eval()
        # verbose: the Python stacks land in each event's ``stack`` (utils/trace.py's source)
        config = torch._C._profiler._ExperimentalConfig(verbose=True)
        with torch.no_grad(), profile(activities=activities, with_stack=True,
                                      experimental_config=config) as prof:
            model(x)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        self.forwards += 1
        trace_dir = os.path.join(self.runner.cfg.work_dir or ".", "traces")
        os.makedirs(trace_dir, exist_ok=True)
        name = self.runner.cfg.config_name or self.runner.cfg.name or "model"
        path = os.path.join(trace_dir, f"{name}.pt.trace.json")
        prof.export_chrome_trace(path)
        logger.info(f"profiler trace of one forward written to {path} "
                    f"(open it in chrome://tracing or Perfetto)")
        tables = {gb: summarize_trace(prof, self.table_row_limit, self.table_exclude, gb)
                  for gb in self.table_group_by}
        tables["range"] = summarize_ranges(prof, self.table_row_limit, self.table_exclude)
        for gb, table in tables.items():
            logger.info(f"Profile by {gb}:\n{table}")
        return dict(trace=path, tables=tables, profile=prof)

"""Forward timing and a profiler capture (port of
``convnet_approximater_tpu/hooks/inference_time_hook.py``).

The forward time is the JAX package's: on the card the slope of a compiled
forward dispatched back to back (:func:`graph_ms`: a ``compile_serving`` CUDA
graph replayed n and 4n times between CUDA events), with the median of
``num_iters`` eager forwards after ``warmup`` reported beside it; on the CPU
the eager median (host clock).  The input is a batch of ones in ``dtype``
(``infer_cfg=dict(bf16=True)``: bfloat16), made as the JAX ``time_forward``
makes it; the model is timed as it is, as the JAX hook times its variables:
a bfloat16 forward needs a model cast first (``utils.dtype.cast_floating``),
and a float32 model under a bfloat16 input raises torch's type error where the
JAX package raises its own.  With ``capture_trace`` (or
``profile_args=dict(capture=True)``) one more forward runs under
``torch.profiler`` after the timed ones, so the profiler's cost never enters
the times: its Chrome trace goes to ``work_dir/traces/``,
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

EVENT_RESOLUTION_MS = 0.5e-3  # CUDA events' resolution: about half a microsecond
MAX_REPLAYS = 4096            # the JAX package's cap on the slope's longer run
CAPTURE_FORWARDS = 4          # compile_serving's forwards: three warm-ups and the capture


def nhwc_size(size):
    """``input_size`` as (B, H, W, C); reference configs give NCHW tuples."""
    size = tuple(size)
    if len(size) == 4 and size[1] in (1, 3) and size[3] not in (1, 3):
        size = (size[0], size[2], size[3], size[1])
    return size


def _ones(input_size, device, dtype=torch.float32) -> torch.Tensor:
    B, H, W, C = input_size
    return torch.ones(B, C, H, W, device=device, dtype=dtype).contiguous(
        memory_format=torch.channels_last)


def eager_times(model, input_size, device, num_iters: int = 10, warmup: int = 3,
                dtype=torch.float32) -> np.ndarray:
    """Milliseconds of each of ``num_iters`` eval forwards of ``model`` on a
    (B, H, W, C) input of ones in ``channels_last`` and ``dtype``, after ``warmup`` forwards:
    each between two CUDA events and synchronized on the card (so the host's
    launch cost enters every reading), on the host clock on the CPU."""
    device = torch.device(device)
    x = _ones(input_size, device, dtype)
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


def graph_ms(model, input_size, num_iters: int = 10, warmup: int = 3,
             dtype=torch.float32) -> float:
    """Milliseconds per forward of ``model`` on the card, as the JAX package's
    ``time_forward`` times a compiled forward: the forward captured as a
    ``deploy.compile_serving`` CUDA graph, then n and 4n replays back to back,
    each run between two CUDA events; the slope between the two runs (the
    least of two of each) cancels the cost of starting and ending a run.
    While the two differ by no more than the events' resolution the runs
    widen 4x, up to 4096 replays.  The graph, and its memory pool, is freed
    before the return, so that a caller that swaps modules between timings
    (the arbiters) captures anew each time.  A forward that cannot be
    captured raises, naming the module."""
    from convnet_approximater_tpu_torch.deploy import compile_serving

    compiled, _ = compile_serving(model, _ones(input_size, next(model.parameters()).device,
                                               dtype))
    replay = compiled.graph.replay

    def run(n: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    try:
        for _ in range(max(warmup, 1)):
            run(1)
        n1, n2 = num_iters, 4 * num_iters
        while True:
            t1 = min(run(n1) for _ in range(2))
            t2 = min(run(n2) for _ in range(2))
            if t2 - t1 > EVENT_RESOLUTION_MS or n2 >= MAX_REPLAYS:
                break
            n1, n2 = 4 * n1, 4 * n2
    finally:
        del compiled, replay
    return max((t2 - t1) / (n2 - n1), 1e-6)


def forward_times(model, input_size, num_iters: int = 10, warmup: int = 3,
                  dtype=torch.float32) -> dict:
    """Both figures of one timing of ``model`` on its parameters' device, on an
    input of ``dtype``:
    ``ms`` (the graph slope of :func:`graph_ms` on the card, the eager median
    on the CPU), ``eager_median_ms`` and the eager ``times``, and
    ``forwards``, the eager forwards run (the capture's included)."""
    device = next(model.parameters()).device
    times = eager_times(model, input_size, device, num_iters, warmup, dtype)
    eager = float(np.median(times))
    if device.type != "cuda":
        return dict(ms=eager, eager_median_ms=eager, times=times, forwards=warmup + num_iters)
    return dict(ms=graph_ms(model, input_size, num_iters, warmup, dtype), eager_median_ms=eager,
                times=times, forwards=warmup + num_iters + CAPTURE_FORWARDS)


def time_forward(model, input_size, device, num_iters: int = 10, warmup: int = 3,
                 dtype=torch.float32):
    """Milliseconds per eval forward of ``model`` on a (B, H, W, C) input of
    ones in ``channels_last``: on the card one entry, :func:`graph_ms`'s slope
    (as the JAX package's ``time_forward`` returns one); on the CPU the
    ``num_iters`` eager times after ``warmup``, as :func:`eager_times`."""
    if torch.device(device).type == "cuda":
        return np.asarray([graph_ms(model, input_size, num_iters, warmup, dtype)])
    return eager_times(model, input_size, device, num_iters, warmup, dtype)


def forward_seconds(model, input_size, num_iters: int = 10, warmup: int = 3,
                    dtype=torch.float32) -> float:
    """Seconds of one eval forward of ``model`` on its parameters' device, the
    default timer of ``ClassInference``, the arbiters and the planner: the
    graph slope on the card (the eager median logged beside it), the eager
    median on the CPU."""
    t = forward_times(model, input_size, num_iters, warmup, dtype)
    if next(model.parameters()).device.type == "cuda":
        get_logger().info(f"forward at {tuple(input_size)}: {t['ms']:.3f} ms as a graph back to "
                          f"back, eager median {t['eager_median_ms']:.3f} ms")
    return t["ms"] / 1e3


@HOOK.register_module()
class InferenceTimeHook(Hook):
    def __init__(self, runner, priority, infer_cfg=None):
        super().__init__(runner, priority)
        infer_cfg = dict(infer_cfg or {})
        self.input_size = nhwc_size(infer_cfg.pop("input_size", (64, 224, 224, 3)))
        self.num_iters = infer_cfg.pop("num_iters", 10)
        self.warmup = max(infer_cfg.pop("warmup", 3), 1)
        self.capture_trace = bool(infer_cfg.pop("capture_trace", False))
        self.dtype = torch.bfloat16 if infer_cfg.pop("bf16", False) else torch.float32
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
                f"InferenceTimeHook options {rest} are not options of the JAX hook")
        self.forwards = 0
        self.result = None

    def after_run(self):
        device = self.runner.device
        t = forward_times(self.runner.model, self.input_size, self.num_iters, self.warmup,
                          self.dtype)
        self.forwards = t["forwards"]
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        times = t["times"]
        eager = (f"median {t['eager_median_ms']:.3f} ms, min {times.min():.3f} ms over "
                 f"{self.num_iters} iters")
        if device.type == "cuda":
            eager = (f"median {t['ms']:.3f} ms per forward as a graph replayed back to back "
                     f"(eager {eager})")
        kind = "" if self.dtype == torch.float32 else ", bfloat16"
        get_logger().info(f"Forward time (batch {self.input_size[0]}{kind}): {eager} on {name}")
        self.result = dict(median_ms=t["ms"], eager_median_ms=t["eager_median_ms"],
                           times=times, device=name, dtype=self.dtype)
        if self.capture_trace:
            self.result.update(self.capture())

    def capture(self) -> dict:
        """One eval forward under ``torch.profiler`` (with Python stacks): its
        Chrome trace under ``work_dir/traces/`` and the logged tables."""
        logger = get_logger()
        device = self.runner.device
        x = _ones(self.input_size, device, self.dtype)
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

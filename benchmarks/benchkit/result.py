"""The run's last line, and the look for JAX in the process."""

from __future__ import annotations

import sys
from types import SimpleNamespace

from yardstick.recipe import read_recipe

from . import family, tracing

# top-level module names that may not be loaded in a run: JAX and the JAX package
# (compared whole: the port, ``convnet_approximater_tpu_torch``, is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "convnet_approximater_tpu")


def forbidden_modules(modules=None):
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def context(cell, outcome):
    """What a per-layer metric's reader reads: the run's spans and trace, and
    the yardstick's counts for the cell."""
    from convnet_approximater_tpu_torch.utils.trace import PORT_KERNELS

    tr, cfg = cell.traffic, cell.config
    rw = read_recipe(cell.workload["recipe"])
    counts = family.yardstick(cfg["family"])
    prefixes = {}
    for prefix, kernel in PORT_KERNELS.items():
        prefixes.setdefault(kernel, []).append(prefix)
    return SimpleNamespace(
        job=tr["job"], batch=tr["batch"], spans=outcome.spans, trace=outcome.trace,
        calls=counts.kernel_calls(cfg["model"], rw, tr["batch"], tr["image_size"]),
        macs=counts.macs_per_image(cfg["model"], rw, tr["image_size"]),
        macs_dense=counts.macs_per_image(cfg["model"], read_recipe([]), tr["image_size"]),
        kernel_prefixes={k: tuple(v) for k, v in prefixes.items()})


def line(cell, outcome, trace: bool, device_info: dict) -> dict:
    if trace:
        ctx = context(cell, outcome)
        metrics = {}
        for m in cell.per_layer:
            value = cell.readers[m["name"]](ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": outcome.e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = dict(device_info, memory_peak_bytes=outcome.memory_peak)
    out = {"correct": outcome.correct, "attempted": outcome.attempted, "failed": outcome.failed,
           "metrics": metrics, "device": device}
    if trace and outcome.trace is not None:
        device.update(busy_s=outcome.trace.busy_s, window_s=outcome.trace.window_s)
        out["breakdown"] = tracing.breakdown(outcome.trace)
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in outcome.checks}
    return out

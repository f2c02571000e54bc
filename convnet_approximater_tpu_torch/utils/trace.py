"""Device-time tables of a ``torch.profiler`` capture: the port's counterpart of
``convnet_approximater_tpu/utils/trace.py`` (``summarize_trace``).

The JAX package parses the Chrome trace XLA's profiler writes; this module
reads the profile object itself.  On the card every kernel, copy and fill is
attributed to the innermost recorded scope that launched it: an ``aten::``
operator, or the ``record_function`` range a port kernel's wrapper opens
around its launch (``ops/build.py::launch_range``; the profiler links no
kernel to a launch through ctypes, so these go by the range's span on the
device).  Device work that no recorded scope launched stays unattributed.
``group_by`` keeps the JAX surface:

* ``op``: the kernel's name;
* ``source``: the innermost frame in this package of the launching scope, with
  the package prefix stripped (from a capture with ``with_stack=True``);
* ``category``: the ``aten::`` operator or the kernel wrapper that launched it.

:func:`summarize_ranges` adds up device time under each ``record_function``
range (``MSCAProfile``'s ``CONV0``/``SD_CONVS``/``CHANNEL_MIX``, the kernel
wrappers).  A capture with no device activity (a CPU run) has no kernels: each
``aten::`` operator's self CPU time stands in for them, and the tables say so.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Tuple

from torch.autograd import DeviceType

PACKAGE_DIR = "convnet_approximater_tpu_torch/"
GROUPS = ("op", "source", "category")
# kernel name -> the wrapper that launches it, for device time no scope claims
PORT_KERNELS = {"march_kernel": "msca_fused", "march_any_kernel": "msca_fused",
                "mix_kernel": "msca_fused", "uniform_kernel": "parallel_cascade",
                "ring_kernel": "parallel_cascade", "lowrank_kernel": "lowrank_conv",
                "qmatmul_kernel": "qmatmul"}


class Record(NamedTuple):
    name: str       # the kernel (on the CPU: the operator)
    us: float       # its time, microseconds
    count: int      # launches this record stands for
    scope: object   # the launching FunctionEvent, or None


def _is_range(event) -> bool:
    return bool(getattr(event, "is_user_annotation", False))


def device_records(prof) -> Tuple[List[Record], bool]:
    """(records, on_device) of a finished ``torch.profiler.profile``.

    On the card: one record per launch that an ``aten::`` operator or a range
    claims (the profiler links the kernels of PyTorch's own launches to their
    operator); each kernel that nothing claims (a launch through ctypes is not
    linked) is scoped to the innermost ``record_function`` range whose span on
    the device holds it, found through the range's host event; the rest of a
    kernel's time stays unattributed.  ``on_device`` is False for a capture
    without device activity, whose records are the ``aten::`` operators' self
    CPU times."""
    events = list(prof.events())
    device = [e for e in events if e.device_type != DeviceType.CPU]
    if not device:
        return [Record(e.name, e.self_cpu_time_total, 1, e) for e in events
                if e.name.startswith("aten::")], False
    kernels = [e for e in device if not _is_range(e)]
    spans = [e for e in device if _is_range(e)]
    hosts = {(e.name, e.id): e for e in events
             if e.device_type == DeviceType.CPU and _is_range(e)}
    records, claimed = [], defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.device_type == DeviceType.CPU and (e.name.startswith("aten::") or _is_range(e)):
            for k in e.kernels:
                records.append(Record(k.name, k.duration, 1, e))
                claimed[k.name][0] += k.duration
                claimed[k.name][1] += 1
    rest = defaultdict(list)
    for e in kernels:
        rest[e.name].append(e)
    for name, evs in rest.items():
        c_us, c_n = claimed.get(name, (0.0, 0))
        if c_n == 0:  # nothing claims this kernel: scope each launch by the ranges' spans
            for e in evs:
                start, end = e.time_range.start, e.time_range.end
                holding = [r for r in spans if r.device_index == e.device_index
                           and r.time_range.start <= start and end <= r.time_range.end]
                span = min(holding, key=lambda r: r.time_range.elapsed_us(), default=None)
                scope = hosts.get((span.name, span.id)) if span is not None else None
                records.append(Record(name, e.time_range.elapsed_us(), 1, scope))
        elif len(evs) > c_n:
            us = sum(e.time_range.elapsed_us() for e in evs)
            records.append(Record(name, max(us - c_us, 0.0), len(evs) - c_n, None))
    return records, True


def _scopes(event) -> Iterator:
    while event is not None:
        yield event
        event = event.cpu_parent


def _source(event) -> str:
    for e in _scopes(event):
        frames = list(e.stack or ())
        if getattr(e, "is_python_function", False):
            frames.append(e.name)
        for frame in frames:
            if PACKAGE_DIR in frame:
                return frame.split(PACKAGE_DIR, 1)[1]
    return "(no source)"


def _category(record: Record) -> str:
    if record.scope is not None:
        return record.scope.name
    for prefix, wrapper in PORT_KERNELS.items():
        if record.name.startswith(prefix):
            return wrapper
    return "(no operator)"


def _table(totals: Dict[str, List[float]], top_k: int, head: str, unit: str) -> str:
    rows = sorted(totals.items(), key=lambda kv: -kv[1][0])[:top_k]
    total_us = sum(us for us, _ in totals.values())
    total = f"TOTAL ({unit})"
    width = max(min(max(len(n) for n, _ in rows), 60), 20, len(total))
    lines = [f"{head:<{width}} | {'total ms':>9} | {'count':>6} | {'%':>6}",
             "-" * (width + 32)]
    for name, (us, n) in rows:
        disp = name if len(name) <= width else name[:width - 1] + "…"
        lines.append(f"{disp:<{width}} | {us / 1e3:9.3f} | {int(n):6d} | "
                     f"{us / max(total_us, 1e-12) * 100:5.1f}%")
    lines.append(f"{total:<{width}} | {total_us / 1e3:9.3f} |")
    return "\n".join(lines)


def summarize_trace(prof, top_k: int = 15, exclude_substrings: Tuple[str, ...] = (),
                    group_by: str = "op") -> str:
    """A text table of the capture's device time grouped by ``group_by`` (``op``,
    ``source`` or ``category``), the ``top_k`` largest rows, leaving out rows
    whose name holds one of ``exclude_substrings``."""
    if group_by not in GROUPS:
        raise ValueError(f"group_by must be one of {GROUPS}, got {group_by!r}")
    records, on_device = device_records(prof)
    key = {"op": lambda r: r.name, "source": lambda r: _source(r.scope),
           "category": _category}[group_by]
    totals: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for r in records:
        name = key(r)
        if not any(s in name for s in exclude_substrings):
            totals[name][0] += r.us
            totals[name][1] += r.count
    if not totals:
        return "(no device work in the capture)" if on_device else "(no operator in the capture)"
    return _table(totals, top_k, group_by, "device" if on_device else "CPU self time, no device")


def range_times(prof) -> Dict[str, List[float]]:
    """``{range: [microseconds, records]}``: the device time under each
    ``record_function`` range of the capture (nested ranges each count it)."""
    return _range_totals(device_records(prof)[0])


def _range_totals(records: List[Record]) -> Dict[str, List[float]]:
    totals: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for r in records:
        for name in {e.name for e in _scopes(r.scope) if _is_range(e)}:
            totals[name][0] += r.us
            totals[name][1] += r.count
    return dict(totals)


def summarize_ranges(prof, top_k: int = 15, exclude_substrings: Tuple[str, ...] = ()) -> str:
    """A text table of :func:`range_times`."""
    records, on_device = device_records(prof)
    totals = {k: v for k, v in _range_totals(records).items()
              if not any(s in k for s in exclude_substrings)}
    if not totals:
        return "(no record_function range in the capture)"
    return _table(totals, top_k, "range", "device" if on_device else "CPU self time, no device")

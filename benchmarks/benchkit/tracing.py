"""What the harness reads from a ``torch.profiler`` capture of its traced
window: every device operation's span, the time the device was busy (the
union of the spans), the time per kernel name, and the longest idle gaps with
the harness's own host span that was open over each."""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from torch.autograd import DeviceType

HOST_SPANS = ("bench.next", "bench.forward", "bench.readback")  # the loop's own ranges


@dataclass
class Trace:
    window_s: float                                   # the traced window, host clock
    busy_s: float                                     # union of the device's operations
    kernel_s: Dict[str, float] = field(default_factory=dict)   # device seconds by name
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # (host span, seconds)
    steps: int = 0                                    # batches or steps in the window


def _union(spans):
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def read(prof, window_s: float, steps: int) -> Trace:
    """A :class:`Trace` of a finished capture (microseconds in, seconds out)."""
    events = list(prof.events())
    device = [e for e in events if e.device_type != DeviceType.CPU
              and not getattr(e, "is_user_annotation", False)]
    spans = [(e.time_range.start, e.time_range.end) for e in device]
    kernel_s = defaultdict(float)
    for e in device:
        kernel_s[e.name] += e.time_range.elapsed_us() / 1e6
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if e.device_type == DeviceType.CPU and e.name in HOST_SPANS]
    gaps = []
    ordered = sorted(spans)
    end = None
    for s, e in ordered:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)

    def label(g0, g1):
        best, best_overlap = "(no host span)", 0.0
        for h0, h1, name in host:
            overlap = min(g1, h1) - max(g0, h0)
            if overlap > best_overlap:
                best, best_overlap = name, overlap
        return best

    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = [(label(g0, g1), (g1 - g0) / 1e6) for g0, g1 in gaps[:10]]
    return Trace(window_s, _union(spans) / 1e6, dict(kernel_s), labelled, steps)


def base_name(kernel: str) -> str:
    """A kernel's function name without its return type, namespaces, template
    arguments and parameters: ``march_kernel`` of ``void (anonymous
    namespace)::march_kernel<21, 5, 4, float>(float const*, ...)``."""
    name = re.sub(r"^void ", "", kernel.replace("(anonymous namespace)::", ""))
    return re.split(r"[<(]", name, maxsplit=1)[0].split("::")[-1]


def kernel_seconds(trace: Trace, prefixes) -> float:
    """Device seconds of the kernels whose function names start with one of
    ``prefixes``."""
    names = [n for n in trace.kernel_s if base_name(n).startswith(tuple(prefixes))]
    return sum(trace.kernel_s[n] for n in names)


def breakdown(trace: Trace) -> dict:
    ops = sorted(trace.kernel_s.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in trace.gaps]}

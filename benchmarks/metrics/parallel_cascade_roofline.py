"""``parallel_cascade``'s share of its roofline in the profiled pass: the least time of
the calls a forward makes (the yardstick's operations and bytes of each call's
shape, each the larger of bytes over 3.35 TB/s and operations over its
precision's peak), times the forwards profiled, over the device time of the
kernels the program names ``parallel_cascade``.  Nothing is read where the cell makes no
such call or the trace shows no such kernel."""

from benchkit.tracing import kernel_seconds
from yardstick.costs import least_seconds

KERNEL = "parallel_cascade"


def read(ctx):
    calls = ctx.calls.get(KERNEL)
    if not calls or ctx.trace is None:
        return None
    seconds = kernel_seconds(ctx.trace, ctx.kernel_prefixes.get(KERNEL, ()))
    if seconds <= 0:
        return None
    return 100.0 * least_seconds(calls) * ctx.trace.steps / seconds

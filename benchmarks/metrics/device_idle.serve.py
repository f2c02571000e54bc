"""The share of the profiled pass's host window in which no operation ran on
the card (the union of the profiler's device spans), in a serving cell."""


def read(ctx):
    t = ctx.trace
    if ctx.job != "serve" or t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

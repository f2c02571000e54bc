"""The whole recovery step's share of the card's peak: the student's forward
three times (forward and backward) and the teacher's once, the yardstick's
MACs per image of each from its module shapes, 2 operations each at float32's
67 TFLOP/s, times the batch, over the traced run's host milliseconds per step
in its window."""

from yardstick.costs import PEAK_F32


def read(ctx):
    if ctx.job != "recover" or not ctx.spans.get("steps"):
        return None
    per_image = 3 * sum(ctx.macs.values()) + sum(ctx.macs_dense.values())
    least = ctx.batch * 2 * per_image / PEAK_F32
    return 100.0 * least / (ctx.spans["window_s"] / ctx.spans["steps"])

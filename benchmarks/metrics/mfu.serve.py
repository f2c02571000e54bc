"""The whole serving step's share of the card's peak: the least time of the
served model's multiply-accumulates per image (the yardstick's count from its
module shapes, 2 operations each, at its precision's peak), times the batch,
over the traced run's host milliseconds per batch in its window."""

from yardstick.costs import PEAK_F32, PEAK_INT8

PEAKS = {"float32": PEAK_F32, "int8": PEAK_INT8}


def read(ctx):
    if ctx.job != "serve" or not ctx.spans.get("batches"):
        return None
    least = ctx.batch * sum(2 * macs / PEAKS[prec] for prec, macs in ctx.macs.items())
    per_batch = ctx.spans["window_s"] / ctx.spans["batches"]
    return 100.0 * least / per_batch

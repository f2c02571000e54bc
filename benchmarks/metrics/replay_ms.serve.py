"""Mean device milliseconds per batch between CUDA events around the serving
graph's call (the input's copy into the graph, the replay and the logits'
copy out), over the traced run's window."""


def read(ctx):
    return ctx.spans.get("replay_ms") if ctx.job == "serve" else None

"""Mean host milliseconds per batch that the serving loop waited in ``next()``
on the program's ``Loader`` (the harness's own span), over the traced run's
window."""


def read(ctx):
    return ctx.spans.get("loader_wait_ms") if ctx.job == "serve" else None

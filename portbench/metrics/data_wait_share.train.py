"""Host time in the harness's span around next(loader), over the window."""

from portbench.metrics._shared import span_share


def read(ctx):
    return span_share(ctx, "data")

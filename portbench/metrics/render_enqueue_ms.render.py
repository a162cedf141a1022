"""Mean host ms of the program's span render.batch: enqueueing one batch's synthesis and its pinned copy."""

from portbench.metrics._program import mean_host_ms


def read(ctx):
    return mean_host_ms(ctx, "render.batch")

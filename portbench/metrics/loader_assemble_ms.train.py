"""Mean host ms of the program's span data.assemble: stacking, flipping and pinning a batch and enqueueing its copy."""

from portbench.metrics._program import mean_host_ms


def read(ctx):
    return mean_host_ms(ctx, "data.assemble")

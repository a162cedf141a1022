"""Mean host ms of the program's span data.wait: next(loader) waiting on the records' queue."""

from portbench.metrics._program import mean_host_ms


def read(ctx):
    return mean_host_ms(ctx, "data.wait")

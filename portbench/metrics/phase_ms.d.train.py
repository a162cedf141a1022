"""Mean device ms of the program's span train_step.d (CUDA events at its entry and exit) over the window's steps that run it."""

from portbench.metrics._program import mean_device_ms


def read(ctx):
    return mean_device_ms(ctx, "train_step.d")

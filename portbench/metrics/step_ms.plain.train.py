"""Mean ms of the window's steps that run neither regularizer, each timed on the device's clock by CUDA events at the steps' ends."""

from portbench.metrics._shared import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "device.step.plain")

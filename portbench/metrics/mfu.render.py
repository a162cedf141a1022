"""Synthesis FLOPs of the frames delivered (counted from the configuration's shapes) per second, over the precision's peak."""

from portbench.metrics._shared import mfu


def read(ctx):
    return mfu(ctx)

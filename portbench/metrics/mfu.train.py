"""FLOPs the window's training steps need (counted from the configuration's shapes) per second, over the precision's peak."""

from portbench.metrics._shared import mfu


def read(ctx):
    return mfu(ctx)

"""Device idle share of the training window: time no operation runs on the card over the window."""

from portbench.metrics._shared import idle_share


def read(ctx):
    return idle_share(ctx)

"""Device ms of the program's sg1.up spans (StyleGAN1's up-convs, their [1, 2, 1] blurs and biases) over device ms of its sg1.synthesis spans."""

from portbench.metrics._span_share import span_device_share


def read(ctx):
    return span_device_share(ctx, "sg1.up", "sg1.synthesis")

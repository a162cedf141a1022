"""Device ms of the program's sg1.epilogue spans (StyleGAN1's noise, leaky ReLU, instance norm and style) over device ms of its sg1.synthesis spans."""

from portbench.metrics._span_share import span_device_share


def read(ctx):
    return span_device_share(ctx, "sg1.epilogue", "sg1.synthesis")

"""The FIR pass's share of device kernel time: at::native's depthwise conv (upfirdn2d's plain form) or the hand-written upfirdn2d kernel."""

from portbench.metrics._shared import kernel_share


def read(ctx):
    return kernel_share(ctx, "conv_depthwise2d", "upfirdn2d")

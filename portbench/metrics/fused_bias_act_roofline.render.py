"""The forward bias-act kernel: the bytes the synthesis' sites need over 3.35 TB/s, against the kernel's device time."""

from portbench.metrics._shared import roofline


def read(ctx):
    return roofline(ctx, "fused_bias_act_kernel", "fused_bias_act_bytes")

"""The bias-act gradient kernel: the bytes the step's gradient passes need over 3.35 TB/s, against its device time."""

from portbench.metrics._shared import roofline


def read(ctx):
    return roofline(ctx, "fused_bias_act_grad_kernel", "fused_bias_act_grad_bytes")

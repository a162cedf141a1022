"""The upfirdn2d kernel in StyleGAN1's synthesis: the bytes its eight blur sites need (portbench/work_sg1.py) over 3.35 TB/s, against the kernel's device time."""

from portbench.metrics._shared import roofline


def read(ctx):
    return roofline(ctx, "upfirdn2d_kernel", "upfirdn2d_bytes")

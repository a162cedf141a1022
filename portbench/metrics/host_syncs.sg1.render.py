"""Synchronizing CUDA calls the host made inside the program's sg1.synthesis spans (counter cuda.syncs, its children's counts included), per forward."""

from portbench.metrics._program import counter_per_span


def read(ctx):
    return counter_per_span(ctx, "sg1.synthesis", "cuda.syncs")

"""Synchronizing CUDA calls the host made inside the program's train_step spans (counter cuda.syncs, its phases' counts included), per step."""

from portbench.metrics._program import counter_per_span


def read(ctx):
    return counter_per_span(ctx, "train_step", "cuda.syncs")

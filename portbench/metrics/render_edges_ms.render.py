"""Host ms per render() call in the program's spans render.prepare, render.stage and render.finish: the work before the first batch and after the last."""

from portbench.metrics._program import host_ms_per


def read(ctx):
    return host_ms_per(ctx, ("render.prepare", "render.stage", "render.finish"), "render")

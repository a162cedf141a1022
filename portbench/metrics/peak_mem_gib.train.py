"""Peak device memory allocated over the training window (the allocator's
peak, reset when the window opens), in GiB."""


def read(ctx):
    peak = ctx["work"].get("peak_mem_bytes")
    if not peak or ctx["trace"] is None:
        return None
    return peak / 2**30

"""Arithmetic the per-layer readers share. Each reader is `read(ctx)`:
ctx holds the cell, the reduced trace (None without one), the harness
spans' host seconds by name, the window's seconds and the work the window
needed, counted from the configuration's shapes. A reader with nothing to
read returns None."""

from __future__ import annotations

from typing import Optional

from portbench.common import HBM_BYTES_PER_S, PEAK_FLOPS
from portbench.trace import kernel_seconds


def base_name(kernel: str) -> str:
    """`fused_bias_act_kernel` of `void (anonymous namespace)::fused_bias_act_kernel<float, 4, int>(...)`."""
    name = kernel.replace("(anonymous namespace)::", "").split("<")[0].split("(")[0]
    return name.split()[-1].split("::")[-1] if name.split() else name


def idle_share(ctx: dict) -> Optional[float]:
    t = ctx["trace"]
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(ctx: dict) -> Optional[float]:
    flops = ctx["work"].get("flops")
    if not flops or ctx["trace"] is None:
        return None
    peak = PEAK_FLOPS[ctx["cell"].config["dtype"]]
    return 100.0 * flops / ctx["window_s"] / peak


def roofline(ctx: dict, kernel: str, work_key: str) -> Optional[float]:
    """Bytes the sites need over HBM bandwidth, against the kernel's device time."""
    if ctx["trace"] is None:
        return None
    seconds = sum(s for name, s in ctx["trace"]["kernel_s"].items() if base_name(name) == kernel)
    need = ctx["work"].get(work_key, 0)
    if seconds <= 0 or not need:
        return None
    return 100.0 * need / HBM_BYTES_PER_S / seconds


def kernel_share(ctx: dict, *needles: str, exclude: tuple[str, ...] = ()) -> Optional[float]:
    t = ctx["trace"]
    if t is None:
        return None
    total = sum(t["kernel_s"].values())
    part = kernel_seconds(t, *needles, exclude=exclude)
    if total <= 0 or part <= 0:
        return None
    return 100.0 * part / total


def span_share(ctx: dict, name: str) -> Optional[float]:
    spans = ctx["spans"].get(name)
    if not spans or ctx["trace"] is None:
        return None
    return 100.0 * sum(spans) / ctx["window_s"]


def span_mean_ms(ctx: dict, name: str) -> Optional[float]:
    spans = ctx["spans"].get(name)
    if not spans or ctx["trace"] is None:
        return None
    return 1000.0 * sum(spans) / len(spans)

"""Profiler phases and traces (counterpart of maua_tpu/telemetry/profiling.py;
the reference's record_function / NVTX phases in train_profile.py).

* `phase(name)`: a `torch.profiler.record_function` range, and an NVTX range
  when a CUDA card is present, so a phase shows in a torch.profiler trace and
  in an external CUDA timeline alike.
* `profile_trace(log_dir)`: a `torch.profiler` trace of the region (CPU, and
  CUDA when a card is present), written as `log_dir/trace.json` (chrome
  trace format) with the top ops by device time, or by CPU time without a
  card, in `log_dir/key_averages.txt`.
* `device_memory_stats`: the allocator stats of `memory.memory_snapshot`.
* `install_compile_metrics` / `log_compile_stats` keep the JAX names: eager
  PyTorch compiles nothing at run time (the kernels are built by nvcc before
  the first launch), so there is no compile event to listen to: False / {}.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch

from .memory import memory_snapshot as device_memory_stats

__all__ = ["device_memory_stats", "install_compile_metrics", "log_compile_stats", "phase", "profile_trace"]


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """A named range in the profiler trace (and in NVTX on a card)."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the region with torch.profiler into `log_dir`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if cuda:
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    sort_by = "cuda_time_total" if cuda else "cpu_time_total"
    with open(os.path.join(log_dir, "key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort_by, row_limit=40))


def install_compile_metrics() -> bool:
    """JAX's compile-event listener: eager PyTorch has no compile events."""
    return False


def log_compile_stats() -> dict[str, float]:
    return {}

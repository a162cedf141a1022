"""Device-memory stats and dumps (counterpart of maua_tpu/telemetry/memory.py;
the reference's gpu_profile.py line tracer).

* `memory_snapshot(device)`: `torch.cuda.memory_stats` of a CUDA device, with
  the JAX names `bytes_in_use` and `peak_bytes_in_use` added for the
  allocated bytes now and at the peak; an empty dict for the CPU, as JAX's
  CPU `memory_stats` gives.
* `save_device_memory_profile(path)`: the caching allocator's snapshot
  (`torch.cuda.memory._dump_snapshot`, a pickle that pytorch.org/memory_viz
  reads), with the allocation history that `record_memory_history` started.
"""

from __future__ import annotations

import torch

from ..device import DeviceLike


def _cuda_device(device: DeviceLike) -> torch.device | None:
    if device is None:
        return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else None
    dev = torch.device(device)
    return dev if dev.type == "cuda" else None


def memory_snapshot(device: DeviceLike = None) -> dict[str, int]:
    """Allocator stats of `device` (default: the current CUDA device; the
    CPU, or no card, gives {})."""
    dev = _cuda_device(device)
    if dev is None:
        return {}
    stats = dict(torch.cuda.memory_stats(dev))
    stats["bytes_in_use"] = stats.get("allocated_bytes.all.current", 0)
    stats["peak_bytes_in_use"] = stats.get("allocated_bytes.all.peak", 0)
    return stats


def record_memory_history(max_entries: int = 100_000) -> None:
    """Start recording allocations with their stacks for the next dump."""
    if not torch.cuda.is_available():
        raise RuntimeError("device memory history needs a CUDA device")
    torch.cuda.memory._record_memory_history(max_entries=max_entries)


def save_device_memory_profile(path: str) -> None:
    """Dump the CUDA caching allocator's snapshot to `path` (RuntimeError
    without a card)."""
    if not torch.cuda.is_available():
        raise RuntimeError("a device memory profile needs a CUDA device")
    torch.cuda.memory._dump_snapshot(path)

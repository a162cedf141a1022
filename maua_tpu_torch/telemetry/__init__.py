"""Observability (counterpart of maua_tpu/telemetry): the program's spans
and counters while a profiler records, profiler traces, device-memory stats
and dumps, the device monitor thread and spectral-norm tracking. The train
CLI's `--profile`, `--monitor` and `--log_spec_norm` use them."""

from .memory import memory_snapshot, save_device_memory_profile
from .profiling import count, current_span, phase, profile_trace, recorded, reset
from .spectral import init_spectral_state, spectral_norms

__all__ = [
    "phase",
    "count",
    "current_span",
    "recorded",
    "reset",
    "profile_trace",
    "init_spectral_state",
    "spectral_norms",
    "memory_snapshot",
    "save_device_memory_profile",
]

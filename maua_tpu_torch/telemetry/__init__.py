"""Observability (counterpart of maua_tpu/telemetry): profiler phases and
traces, device-memory stats and dumps, the device monitor thread and
spectral-norm tracking. The train CLI's `--profile`, `--monitor` and
`--log_spec_norm` use them."""

from .memory import log_memory_deltas, memory_snapshot, save_device_memory_profile
from .profiling import device_memory_stats, install_compile_metrics, log_compile_stats, phase, profile_trace
from .spectral import init_spectral_state, spectral_norms

__all__ = [
    "phase",
    "profile_trace",
    "device_memory_stats",
    "log_compile_stats",
    "install_compile_metrics",
    "init_spectral_state",
    "spectral_norms",
    "memory_snapshot",
    "log_memory_deltas",
    "save_device_memory_profile",
]

"""Arithmetic of the readers of the program's own spans and counters
(`maua_tpu_torch.telemetry.recorded()`: per span name its count, host
seconds, device ms where timed, and counters). The harness profiles the
window alone, so the recorder holds what the window recorded. A program
without the recorder, or a run without a trace, has nothing to read: None."""

from __future__ import annotations

from typing import Optional


def recorded(ctx: dict) -> Optional[dict]:
    if ctx["trace"] is None:
        return None
    try:
        from maua_tpu_torch import telemetry
    except ImportError:
        return None
    read = getattr(telemetry, "recorded", None)
    return read() if read is not None else None


def _span(ctx: dict, name: str) -> Optional[dict]:
    spans = recorded(ctx)
    span = spans.get(name) if spans else None
    return span if span and span["count"] else None


def mean_device_ms(ctx: dict, name: str) -> Optional[float]:
    span = _span(ctx, name)
    if span is None or span["device_ms"] is None:
        return None
    return span["device_ms"] / span["count"]


def mean_host_ms(ctx: dict, name: str) -> Optional[float]:
    span = _span(ctx, name)
    return None if span is None else 1000.0 * span["host_s"] / span["count"]


def counter_per_span(ctx: dict, name: str, counter: str) -> Optional[float]:
    """The counter over all spans `name` (their children's counts included), per span."""
    span = _span(ctx, name)
    return None if span is None else span["counters"].get(counter, 0) / span["count"]


def host_ms_per(ctx: dict, names: tuple[str, ...], per: str) -> Optional[float]:
    """Host ms of the spans `names` together, per span `per`."""
    outer = _span(ctx, per)
    if outer is None:
        return None
    spans = recorded(ctx)
    return 1000.0 * sum(spans[n]["host_s"] for n in names if n in spans) / outer["count"]

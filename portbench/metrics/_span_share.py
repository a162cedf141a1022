"""The device time of one of the program's spans as a share of another's
(`maua_tpu_torch.telemetry.recorded()`). None where either span is missing or
has no device time: a run without a trace, or a program without the spans."""

from __future__ import annotations

from typing import Optional

from portbench.metrics._program import recorded


def span_device_share(ctx: dict, part: str, whole: str) -> Optional[float]:
    """Device ms of the spans `part` over device ms of the spans `whole`, in %."""
    spans = recorded(ctx) or {}
    a, b = spans.get(part), spans.get(whole)
    if not a or not b or not a["device_ms"] or not b["device_ms"]:
        return None
    return 100.0 * a["device_ms"] / b["device_ms"]

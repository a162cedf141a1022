"""Reduce a torch.profiler trace of the measured window to what the
per-layer metrics and the result line read: device time by kernel name, the
seconds in which any operation ran on the device (the union of their
intervals), and the idle gaps labelled by what the host was doing.

The window is the harness span `portbench.window`; the host's doing at an
idle moment is the innermost harness span open on the main thread at the
middle of the gap, and the innermost operation below it ("python" when none
is open).
"""

from __future__ import annotations

import bisect
from collections import defaultdict

SPAN_PREFIX = "portbench."


def _events(prof):
    return prof.profiler.kineto_results.events()


def reduce(prof) -> dict:
    """{"kernel_s": {name: s}, "busy_s", "window_s", "device_ops", "idle_gaps"}
    over the `portbench.window` span of the profile."""
    from torch.autograd import DeviceType

    events = list(_events(prof))
    marks = [e for e in events if e.name() == SPAN_PREFIX + "window" and e.device_type() != DeviceType.CUDA]
    if not marks:
        raise RuntimeError("the trace holds no portbench.window span")
    main_tid = marks[0].start_thread_id()  # the thread that opened the window
    window = (marks[0].start_ns(), marks[0].start_ns() + marks[0].duration_ns())
    # a record_function range is mirrored on the device's timeline under its
    # own name: it is no device work, so names that the host also records go
    host_names = {e.name() for e in events if e.device_type() != DeviceType.CUDA}
    dev, cpu = [], []
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.name() not in host_names and not e.name().startswith(SPAN_PREFIX):
                dev.append((start, start + dur, e.name()))
        elif e.start_thread_id() == main_tid:
            cpu.append((start, start + dur, e.name()))
    w0, w1 = window
    kernel_s: dict[str, float] = defaultdict(float)
    intervals = []
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            kernel_s[name] += (e - s) * 1e-9
            intervals.append((s, e))
    intervals.sort()
    merged: list[list[int]] = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_ns = sum(e - s for s, e in merged)
    gaps, at = [], w0
    for s, e in merged:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if w1 > at:
        gaps.append((at, w1))
    idle = _label_gaps(gaps, cpu)
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])
    return {
        "kernel_s": dict(kernel_s),
        "busy_s": busy_ns * 1e-9,
        "window_s": (w1 - w0) * 1e-9,
        "device_ops": [[name[:200], s] for name, s in top[:10]],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:10],
    }


def _label_gaps(gaps: list[tuple[int, int]], cpu: list[tuple[int, int, str]]) -> dict[str, float]:
    """Idle seconds by (innermost harness span > innermost op) at each gap's middle."""
    cpu = sorted(cpu, key=lambda ev: (ev[0], -ev[1]))
    starts = [ev[0] for ev in cpu]
    out: dict[str, float] = defaultdict(float)
    stack: list[tuple[int, int, str]] = []
    i = 0
    for g0, g1 in sorted(gaps):
        mid = (g0 + g1) // 2
        j = bisect.bisect_right(starts, mid)
        while i < j:  # open every event that starts before the middle; nested ranges stack
            ev = cpu[i]
            while stack and stack[-1][1] <= ev[0]:
                stack.pop()
            stack.append(ev)
            i += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        open_ = [ev for ev in stack if ev[1] > mid]
        spans = [ev[2][len(SPAN_PREFIX):] for ev in open_ if ev[2].startswith(SPAN_PREFIX) and ev[2] != SPAN_PREFIX + "window"]
        ops = [ev[2] for ev in open_ if not ev[2].startswith(SPAN_PREFIX)]
        label = f"{spans[-1] if spans else 'window'} > {ops[-1] if ops else 'python'}"
        out[label[:200]] += (g1 - g0) * 1e-9
    return out


def kernel_seconds(trace: dict, *needles: str, exclude: tuple[str, ...] = ()) -> float:
    """Device seconds of the kernels whose name holds any needle and no excluded part."""
    return sum(s for name, s in trace["kernel_s"].items()
               if any(n in name for n in needles) and not any(x in name for x in exclude))

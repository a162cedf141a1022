"""Spans, counters and profiler traces of the program (counterpart of
maua_tpu/telemetry/profiling.py; the reference's record_function / NVTX
phases in train_profile.py).

Tracing is on exactly while a `torch.profiler` records on the calling thread
(`torch.autograd._profiler_enabled()`, thread-local): the train CLI's
`--profile`, a benchmark's traced window, or any profile a caller opens.
There is no flag. While it is off, `phase` returns one shared no-op context
and `count` does nothing: no NVTX, no profiler range, no event, no
allocation.

* `phase(name, *, request=None, device=None)`: while on, a span: a
  `torch.profiler.record_function` range under `name` (in the profiler's
  trace, on the clock of the device's kernels), an NVTX range on a CUDA
  build, and a record kept in memory: the name, the parent span (the
  innermost span open on the thread), the request id and the host start and
  end (`time.perf_counter_ns`). With `device` a CUDA device, a pair of timing
  CUDA events on its current stream at entry and exit, with no synchronize;
  they are read when the summary is asked for.
* `count(name, n=1, span=None)`: while on, adds `n` to the counter `name` of
  the innermost span open on the thread; a span's counters hold what was
  counted during it, its children's counts included. Without an open span it
  counts nothing. With `span`, a handle from `current_span()`, it adds to
  that span from any thread: autograd runs a CUDA backward on a thread of its
  own, where no span is open.
* `current_span()`: the innermost span open on the calling thread while on,
  else None.
* Counter `cuda.syncs`: while on, the synchronizing CUDA calls the host makes
  (a copy between the device and pageable host memory, `.item()`, a stream
  synchronize: the calls that `torch.cuda.set_sync_debug_mode` flags, which
  is set to warn while a span is open), each counted under the innermost
  open span of the thread that made it. An event's synchronize is not
  counted.
* `recorded()`: per span name, {"count", "host_s", "device_ms" (the sum over
  the timed spans; None where untimed), "counters"}. `reset()` clears the
  records.
* `profile_trace(log_dir)`: resets the records, traces the region with
  torch.profiler (CPU, and CUDA when a card is present) and writes
  `log_dir/trace.json` (chrome trace format), the top ops by device time, or
  by CPU time without a card, in `log_dir/key_averages.txt`, and the spans
  in `log_dir/spans.json`: {"spans": recorded(), "records": one object per
  span in the order they closed, with name, parent, request, start_ns,
  end_ns, device_ms and counters}.

The program's spans (request id in brackets):
* train/step.py: `train_step` [state.step], and its phases `train_step.d`,
  `.r1`, `.ada`, `.g`, `.path`, `.tail` [state.step], all device-timed.
* data/loader.py: `data` (all of `DataLoader.__next__`), `data.wait` (the
  records' queue), `data.assemble` (stack, layout check, flips, pin, the
  copy's enqueue) [the loader's batch serial]; counter `data.starved`: calls
  that found fewer records queued than the batch needs.
* render/frames.py: `render` (all of `render()`), `render.prepare` (checks,
  host conversion and padding of the timelines, replicas, the writer and its
  thread), `render.stage` (the timeline's upload; empty when it does not
  fit), `render.finish` (the last fetch, the writer's join and close) [the
  call serial]; `render.batch` (synthesis plus the pinned copy's enqueue) and
  `render.fetch` (the copy's event wait, the copy out of the pinned slot and
  the queue put) [(call serial, batch)].
* models/stylegan1.py, all device-timed: `sg1.synthesis` (the blocks and
  torgb, one a forward), `sg1.up` (each block's up-conv, blur and bias),
  `sg1.epilogue` (each noise, leaky-ReLU, instance norm and style).
* ops/conv.py: counter `conv.second_order`, each conv double backward (R1
  and the path penalty differentiated with respect to the parameters),
  under the span open when its forward conv ran.
No span name starts with `portbench.`: a benchmark keeps that prefix for its
own spans.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
import warnings
from typing import Any, Iterator, Optional

import torch

__all__ = ["count", "current_span", "phase", "profile_trace", "recorded", "reset"]

_OFF = contextlib.nullcontext()
_SYNC_MESSAGE = "called a synchronizing CUDA operation"
_tracing = torch.autograd._profiler_enabled


@functools.cache
def _nvtx() -> bool:
    return torch.cuda.is_available()


class _Open(threading.local):
    """The calling thread's open spans, innermost last."""

    def __init__(self):
        self.stack: list[_Span] = []


class _Recorder:
    """The closed spans, each thread's open ones, and the sync watch: the
    warnings hook and the sync debug mode, held while any thread has a span
    open."""

    def __init__(self):
        self.records: list[_Span] = []
        self.open = _Open()
        self.lock = threading.Lock()
        self.open_threads = 0
        self.watch: Optional[tuple[Any, Optional[int]]] = None

    def watch_syncs(self) -> None:
        with self.lock:
            self.open_threads += 1
            if self.open_threads > 1:
                return
            catcher = warnings.catch_warnings()
            catcher.__enter__()
            warnings.filterwarnings("always", message=_SYNC_MESSAGE)
            mode = None
            if torch.cuda.is_initialized() and torch.cuda.get_sync_debug_mode() == 0:
                mode = 0
                torch.cuda.set_sync_debug_mode("warn")
            shown = warnings.showwarning

            def show(message, category, filename, lineno, file=None, line=None):
                if str(message).startswith(_SYNC_MESSAGE):
                    count("cuda.syncs")
                    if mode == 0:  # the warning exists only because the watch asked for it
                        return
                shown(message, category, filename, lineno, file, line)

            warnings.showwarning = show
            self.watch = (catcher, mode)

    def unwatch_syncs(self) -> None:
        with self.lock:
            self.open_threads -= 1
            if self.open_threads or self.watch is None:
                return
            catcher, mode = self.watch
            self.watch = None
            if mode is not None:
                torch.cuda.set_sync_debug_mode(mode)
            catcher.__exit__(None, None, None)


_rec = _Recorder()


class _Span:
    __slots__ = ("name", "request", "parent", "start_ns", "end_ns", "counters", "device_ms", "_device", "_events",
                 "_range")

    def __init__(self, name: str, request: Any, device: Optional[torch.device]):
        if name.startswith("portbench."):
            raise ValueError(f"span {name!r}: the prefix portbench. is a benchmark's")
        self.name, self.request = name, request
        self.counters: dict[str, int] = {}
        self.device_ms: Optional[float] = None
        self._device = device if device is not None and torch.device(device).type == "cuda" else None
        self._events = None

    def __enter__(self) -> "_Span":
        self.start_ns = time.perf_counter_ns()
        stack = _rec.open.stack
        self.parent = stack[-1].name if stack else None
        if not stack:
            _rec.watch_syncs()
        stack.append(self)
        self._range = torch.autograd.profiler.record_function(self.name)
        self._range.__enter__()
        if _nvtx():
            torch.cuda.nvtx.range_push(self.name)
        if self._device is not None:
            self._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self._events[0].record(torch.cuda.current_stream(self._device))
        return self

    def __exit__(self, *exc) -> bool:
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self._device))
        if _nvtx():
            torch.cuda.nvtx.range_pop()
        self._range.__exit__(*exc)
        self._range = None
        stack = _rec.open.stack
        stack.pop()
        if stack:
            outer = stack[-1].counters
            for k, v in self.counters.items():
                outer[k] = outer.get(k, 0) + v
        else:
            _rec.unwatch_syncs()
        self.end_ns = time.perf_counter_ns()
        _rec.records.append(self)
        return False

    def read_device(self) -> Optional[float]:
        """Device ms between the span's events (waits for the exit event once)."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self.device_ms = start.elapsed_time(end)
            self._events = None
        return self.device_ms

    def as_dict(self) -> dict:
        return {"name": self.name, "parent": self.parent, "request": self.request, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "device_ms": self.read_device(), "counters": dict(self.counters)}


def phase(name: str, *, request: Any = None, device: Optional[torch.device] = None):
    """A span named `name` while tracing is on (see the module docstring);
    the shared no-op context while it is off. `request`: the id of the request,
    step or batch the span serves. `device`: the device the span's work runs
    on; a CUDA device is timed by events."""
    if not _tracing():
        return _OFF
    return _Span(name, request, device)


def current_span() -> Optional[_Span]:
    """The innermost span open on the calling thread while on, else None."""
    if not _tracing():
        return None
    stack = _rec.open.stack
    return stack[-1] if stack else None


def count(name: str, n: int = 1, span: Optional[_Span] = None) -> None:
    """Add `n` to the counter `name` of `span` (a `current_span()` of any
    thread), or else of the calling thread's innermost open span (while on)."""
    if span is None:
        span = current_span()
        if span is None:
            return
    span.counters[name] = span.counters.get(name, 0) + n


def recorded() -> dict[str, dict]:
    """Per span name: {"count", "host_s", "device_ms", "counters"} over the
    spans closed since the last reset."""
    out: dict[str, dict] = {}
    for span in list(_rec.records):
        s = out.setdefault(span.name, {"count": 0, "host_s": 0.0, "device_ms": None, "counters": {}})
        s["count"] += 1
        s["host_s"] += (span.end_ns - span.start_ns) * 1e-9
        ms = span.read_device()
        if ms is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + ms
        for k, v in span.counters.items():
            s["counters"][k] = s["counters"].get(k, 0) + v
    return out


def reset() -> None:
    """Forget the closed spans."""
    _rec.records.clear()


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the region with torch.profiler into `log_dir` (trace.json,
    key_averages.txt, spans.json)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if cuda:
        torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    sort_by = "cuda_time_total" if cuda else "cpu_time_total"
    with open(os.path.join(log_dir, "key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort_by, row_limit=40))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({"spans": recorded(), "records": [s.as_dict() for s in list(_rec.records)]}, f)

"""What every cell shares: finding its files by name, the device and the
result line, harness spans, peaks and the look for JAX.

A cell is an entry of `workloads` in BENCHMARK.json. Its configuration is
`configs/<config>.json`, its traffic `workloads/<traffic>.json`; the traffic
names its driver module (`drivers/<name>.py`), and each per-layer metric of the
cell is read by `metrics/<metric name>.py`. A later change adds a cell, a
configuration, a traffic mix or a metric as new files and entries.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Iterator, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "maua_tpu")  # top-level module names, compared whole

# NVIDIA H100 SXM data sheet, dense rates (700 W)
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or benchmark()
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    entry = entries[0]
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name,
        entry=entry,
        config=load_json(ROOT / conf["file"]),
        traffic=load_json(HERE / "workloads" / f"{entry['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def driver(cell: Cell):
    return importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")


def reader(metric: str) -> Callable[[dict], Optional[float]]:
    """`read(ctx)` of metrics/<metric>.py (a file name may hold dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Spans:
    """Harness spans: host-clock durations by name, and a profiler range
    (`portbench.<name>`) so a trace shows what the host was doing."""

    def __init__(self):
        self.seconds: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        import torch

        with torch.profiler.record_function(f"portbench.{name}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds.setdefault(name, []).append(time.perf_counter() - t0)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(count))}


def metric(value: float, unit: str) -> dict:
    return {"value": value, "unit": unit}


def checks_block(numbers: dict[str, tuple[float, float]]) -> dict[str, Any]:
    """{name: {"value": v, "limit": l}} of the numbers compared."""
    return {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}


def print_checks(numbers: dict[str, tuple[float, float]]) -> None:
    for k, (v, lim) in numbers.items():
        print(f"check {k} = {v!r} (limit {lim!r}): {'ok' if v <= lim else 'FAILED'}", file=sys.stderr, flush=True)

"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload ffhq1024.render --seed 7 --seconds 10 --trace 0

Set-up (from process start to the first timed call) is `setup_s`. The window
then measures for `--seconds`; `--trace 1` profiles it and prints the
per-layer metrics instead of the end-to-end ones. Once the window has closed,
the device's peak memory is read, the program is freed and the reference
judges what the window produced. The last line of standard output is one
JSON object: correct, attempted, failed, metrics, device, with --trace 1
breakdown, and last the numbers compared beside their limits (also the last
lines of standard error). Without a CUDA card, with fewer cards than the cell
asks for, or with JAX or the JAX package loaded, it prints no result and
exits with another code than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

from .common import HERE, find_cell, load_json  # noqa: E402


def limits(cell_name: str) -> dict[str, float]:
    return load_json(HERE / "limits" / f"{cell_name}.json")


def execute(cell, seed: int, seconds: float, trace: bool, device: str = "cuda", t_start: float | None = None) -> dict:
    """One run of `cell`; returns the result object (printed by main). A
    CPU device runs the same steps at whatever size the cell holds, for the
    tests."""
    import torch

    from . import common
    from . import trace as tr

    t_start = time.perf_counter() if t_start is None else t_start
    drv = common.driver(cell)
    cuda = device != "cpu"
    state = drv.setup(cell, seed, device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    try:
        res = drv.window(state, seconds, traced=trace)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    reduced = tr.reduce(prof) if prof is not None and cuda else None
    if cuda:
        dev = common.device_info(cell.entry["chips"])
        dev["memory_peak_bytes"] = max(dev["memory_peak_bytes"], getattr(state, "setup_peak", 0))
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    work = drv.work(state)
    drv.release(state)

    numbers, missing = drv.judge(state)
    lim = limits(cell.name)
    checks = {k: (numbers[k], v) for k, v in lim.items()}
    finite = all(math.isfinite(v) for v in res.values())
    correct = finite and missing == 0 and all(v <= lim_ for v, lim_ in checks.values())

    if trace:
        ctx = {"cell": cell, "trace": reduced, "spans": state.spans.seconds, "window_s": res["window_s"],
               "work": work}
        metrics = {}
        for m in cell.per_layer:
            value = common.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = common.metric(value, m["unit"])
        if reduced is not None:
            dev.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
    else:
        metrics = {}
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else res[m["name"]]
            metrics[m["name"]] = common.metric(value, m["unit"])
    attempted, failed = drv.counts(state, missing)
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if reduced is not None:
        out["breakdown"] = {"device_ops": reduced["device_ops"], "idle_gaps": reduced["idle_gaps"]}
    out["checks"] = common.checks_block(checks)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = find_cell(args.workload)

    import torch

    from . import common

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
        print(f"portbench: the cell needs {cell.entry['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = common.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    common.print_checks({k: (v["value"], v["limit"]) for k, v in result["checks"].items()})
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that the limits of `correct` are set from; the benchmark's own
runs never run this.

    python3 -m portbench.calibrate --workload <cell> --mode program --seeds 1,2,3
    python3 -m portbench.calibrate --workload <cell> --mode control --seeds 1,2,3
    python3 -m portbench.calibrate --workload <cell> --mode half_batch --seeds 1,2,3

`program`: the program's own runs (set-up, one render call or the compared
training steps, the reference), the lower readings; for training, with the
look behind D's first gradient (`drivers/train.py::look`). `control`: the reference
put in the program's place in TF32, judged by the fp32 reference.
`half_batch` (training): the reference put in the program's place in fp32
with half of every batch left out and each mean taken over the rest. One
JSON line per seed on standard output, with every number the cell's
judge computes. `witness` (training): the program's and the fp32 reference's
gaps against a float64 reference of the same steps.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .common import driver, find_cell


def reading(cell, seed: int, mode: str, device: str = "cuda") -> dict:
    drv = driver(cell)
    t0 = time.perf_counter()
    state = drv.setup(cell, seed, device)
    if cell.traffic["driver"] == "render":
        drv.window(state, 0.0)  # one call
    drv.release(state)
    if mode == "witness":
        return {"cell": cell.name, "mode": mode, "seed": seed, **drv.witness(state)}
    if mode == "program" and cell.traffic["driver"] == "train":
        numbers = drv.look(state)
    elif mode == "program":
        numbers, missing = drv.judge(state)
        numbers["missing"] = missing
    elif cell.traffic["driver"] == "render":
        numbers = drv.control(state, [(c, int(f)) for c, clip in enumerate(state.clips) for f in clip.judged])
    else:
        numbers = drv.control(state, None if mode == "control" else mode)
    return {"cell": cell.name, "mode": mode, "seed": seed, "seconds": time.perf_counter() - t0, **numbers}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", default="program")
    p.add_argument("--seeds", required=True, help="comma-separated")
    args = p.parse_args(argv)
    cell = find_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(reading(cell, seed, args.mode)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

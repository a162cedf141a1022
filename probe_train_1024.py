#!/usr/bin/env python3
"""Where the time of a 1024^2 R1 + path step goes, op by op, on one CUDA card.

    python3 probe_train_1024.py [--fp32] [--out probe_train_1024.json]

Builds the kernels, then runs the train step's phases (train/step.py) of the
JAX package's flagship training configuration (1024^2, batch 12, channel
multiplier 2, channel_max 512, constant input, ADA with the fft and 1x-grid
warps, reg_chunks 3, remat_synth; bf16 unless --fp32) from random weights
and random reals: one warm-up step with R1 and the path penalty, then each
phase once more unprofiled and once under torch.profiler with the input
shapes recorded. For each phase it prints the host ms until the phase returns
and the wall ms until the card is done (unprofiled, from an idle card), the
device time of the phase, its operators with the most device time (self CUDA
time, grouped by operator and input shapes), its kernels with the most device
time and its operators with the most host time (self CPU time), and the
card's name and power limit.
Needs a card; prints nothing else.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def top_ops(prof, n: int = 8) -> list:
    rows = []
    for ev in prof.key_averages(group_by_input_shape=True):
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0 and not str(ev.device_type).endswith("CUDA"):
            rows.append(dict(op=ev.key, shapes=str(ev.input_shapes)[:200], device_ms=dev_us / 1e3, calls=ev.count))
    return sorted(rows, key=lambda r: -r["device_ms"])[:n]


def top_host(prof, n: int = 8) -> list:
    rows = [dict(op=ev.key[:80], self_cpu_ms=ev.self_cpu_time_total / 1e3, calls=ev.count)
            for ev in prof.key_averages() if not str(ev.device_type).endswith("CUDA")]
    return sorted(rows, key=lambda r: -r["self_cpu_ms"])[:n]


def host_and_wall_ms(fn) -> tuple[float, float]:
    """(ms until fn returns, ms until the card has finished), from an idle card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3


def top_kernels(prof, n: int = 8) -> list:
    rows = [dict(kernel=ev.key[:120], device_ms=getattr(ev, "self_device_time_total", 0) / 1e3, calls=ev.count)
            for ev in prof.key_averages() if str(ev.device_type).endswith("CUDA")]
    return sorted(rows, key=lambda r: -r["device_ms"])[:n]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_train_1024: torch.cuda.is_available() is False; this script needs a CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from maua_tpu_torch.models.blocks import tf32
    from maua_tpu_torch.ops import _build
    from maua_tpu_torch.train import draw_step, init_train_state, make_train_config, make_train_phases, make_train_step
    from maua_tpu_torch.train.step import prepare_reals

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.build()
    cfg = make_train_config(size=1024, batch_size=12, channel_multiplier=2, channel_max=512, constant_input=True,
                            augment=True, ada_warp_method="fft", ada_fast_warp=True, bf16=not args.fp32, reg_chunks=3,
                            remat_synth=True)
    state = init_train_state(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    u8 = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (1, 12, 1024, 1024, 3), dtype=np.uint8)).cuda()
    make_train_step(cfg)(state, u8, draw_step(cfg, 0, gen, "cuda"))  # warm-up: R1 and the path penalty
    torch.cuda.synchronize()
    phases, real = make_train_phases(cfg), prepare_reals(u8)
    draws = draw_step(cfg, 0, gen, "cuda")
    calls = {"d": lambda: phases["d"](state, real, draws.d), "r1": lambda: phases["r1"](state, real),
             "g": lambda: phases["g"](state, draws.g), "path": lambda: phases["path"](state, draws.path)}
    out = {"device": smi, "config": "fp32_exact" if args.fp32 else "bf16", "phases": {}}
    with tf32(conv=False, matmul=False):
        for name, fn in calls.items():
            host_ms, wall_ms = host_and_wall_ms(fn)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
                fn()
                torch.cuda.synchronize()
            kernels_ms = sum(getattr(ev, "self_device_time_total", 0) for ev in prof.key_averages()
                             if str(ev.device_type).endswith("CUDA")) / 1e3
            out["phases"][name] = dict(kernel_ms=kernels_ms, host_ms=host_ms, wall_ms=wall_ms, top_ops=top_ops(prof),
                                       top_kernels=top_kernels(prof), top_host=top_host(prof))
    print(smi)
    print(json.dumps(out, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Probe the forward kernel of maua_tpu_torch/csrc/fused_bias_act.cu on a CUDA
card: its launcher against an older one, under both of chip_smoke.py's
timers, and its 32-bit index against a 64-bit one.

    mkdir -p output && git show <rev>:maua_tpu_torch/csrc/fused_bias_act.cu > output/old_fba.cu
    python3 probe_fused_bias_act.py --old output/old_fba.cu --out output/probe_fba.json

Builds three libraries of the forward, each with nvcc for sm_90a (in
parallel):
  * `current`: the source as it stands (one flat index over the tensor,
    32-bit below 2^31 elements);
  * `old`: the source given with --old (the parent commit's launches one
    block per row and a flat index only for short rows);
  * `flat64`: the current source with the 64-bit index on every tensor, made
    by replacing the launcher's condition in a copy of the source (the probe
    fails if the text it replaces is not there).

Then:
  1. every library's output equals `current`'s bit for bit, and `current`
     is within the kernel tests' tolerance of the plain PyTorch form, on
     odd and main-path shapes, fp32 and bf16, with and without bias, and on
     [64, 32, 1024^2] in bf16 (2^31 elements, the 64-bit index);
  2. the VAE train step's forward launches (recorded from one train_vae
     step of chip_smoke's LogCoshVAE at 64^2, batch 64), timed per shape for
     `old`, `current` and the plain form under both timers (graph_ms with
     its sleep, and with sleep_cycles=0, the back-to-back timer), summed over
     the step with each shape's launches, fp32 and bf16;
  3. wide rows (the render batch [8, 32, 1024^2], [8, 512, 64, 64],
     [64, 32, 64, 64], ...) timed for `old`, `current` and `flat64`, fp32 and
     bf16, each twice in mirrored order.
Prints nvidia-smi's name and power limit first, one JSON line per reading,
and writes all readings to --out.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402
from maua_tpu_torch.ops import _build  # noqa: E402
from maua_tpu_torch.ops.fused_act import _DTYPE_CODES, _rows_cols, fused_leaky_relu_plain  # noqa: E402

SOURCE = _build.CSRC_DIR / "fused_bias_act.cu"
CONDITION = "if (n < ((int64_t)1 << 31)) {"
VARIANTS = {"flat64": "if (false) {"}
WIDE = [(8, 32, 1024, 1024), (8, 64, 512, 512), (8, 512, 64, 64), (8, 512, 32, 32), (64, 32, 64, 64), (64, 32, 32, 32)]
BIG = (64, 32, 1024, 1024)  # 2^31 elements: the 64-bit index, bf16 only
CHECK = [(5, 7, 3, 3), (2, 3, 5), (3, 130), (130,), (8, 512), (16384, 512), (64, 512, 2, 2), (64, 256, 4, 4),
         (64, 128, 8, 8), (64, 64, 16, 16), (64, 32, 32, 32), (64, 32, 64, 64), (4, 3, 1, 1), (2, 6, 2, 3),
         (8, 512, 64, 64), (8, 32, 1024, 1024)]


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def build_all(old: str, workdir: str) -> dict:
    """{name: loaded CDLL} for current (built by the package), old and the
    flat variants (built here, one nvcc each, in parallel)."""
    libs = {"current": ctypes.CDLL(str(_build.build()["fused_bias_act"]))}
    text = SOURCE.read_text()
    if text.count(CONDITION) != 1:
        raise RuntimeError("the launcher's condition is not in the source as the probe expects it")
    os.makedirs(workdir, exist_ok=True)
    sources = {"old": old}
    for name, repl in VARIANTS.items():
        sources[name] = os.path.join(workdir, f"fba_{name}.cu")
        with open(sources[name], "w") as f:
            f.write(text.replace(CONDITION, repl))
    procs = {name: subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", os.path.join(workdir, f"fba_{name}.so"), src],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, src in sources.items()}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        libs[name] = ctypes.CDLL(os.path.join(workdir, f"fba_{name}.so"))
    argtypes, restype = _build._SIGNATURES["fused_bias_act"]["fused_bias_act"]
    for lib in libs.values():
        lib.fused_bias_act.argtypes, lib.fused_bias_act.restype = argtypes, restype
    return libs


def caller(lib):
    """fn(x, bias) -> out through `lib`'s forward entry point, as the
    package's wrapper calls it (same rows / cols / channels view)."""
    def fn(x, b):
        rows, cols, ch = _rows_cols(x)
        out = torch.empty_like(x)
        err = lib.fused_bias_act(x.data_ptr(), None if b is None else b.data_ptr(), out.data_ptr(), rows, cols, ch,
                                 1 if x.ndim >= 3 else 0, _DTYPE_CODES[x.dtype], 0.2, 2 ** 0.5,
                                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"fused_bias_act returned CUDA error {err}")
        return out
    return fn


def inputs(shape, dtype, with_bias, g):
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    ch = shape[1] if len(shape) >= 3 else shape[-1]
    b = torch.randn(ch, generator=g, device="cuda").to(dtype).float() if with_bias else None
    return x, b


def timer(fn, numel: int, sleep_cycles: int) -> float:
    reps, runs = (10, 25) if numel < 2**24 else (3, 10)
    return cs.graph_ms(fn, reps=reps, runs=runs, sleep_cycles=sleep_cycles)


def bound_ms(x, b) -> float:
    return (2 * x.numel() * x.element_size() + (0 if b is None else 4 * b.numel())) / cs.HBM_BYTES_PER_S * 1e3


def check(fns: dict) -> None:
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = list(itertools.product(CHECK, (torch.float32, torch.bfloat16), (True, False))) + [(BIG, torch.bfloat16, True)]
    for shape, dtype, wb in cases:
        x, b = inputs(shape, dtype, wb, g)
        got = fns["current"](x, b)
        tol = dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32 else dict(rtol=1.6e-2, atol=1e-2)
        torch.testing.assert_close(got.float(), fused_leaky_relu_plain(x, b).float(), **tol)
        for name, fn in fns.items():
            torch.testing.assert_close(fn(x, b), got, rtol=0, atol=0, msg=f"{name} at {shape} {dtype}")
        del x, b, got
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit(phase="check", shapes=len(CHECK) + 1, libraries=sorted(fns), result="every library equals current bit for bit")


def vae_step_shapes() -> list:
    """[(shape, with bias, launches per step)] of the forward in one LogCoshVAE train
    step (chip_smoke's VAE: 64^2, batch 64, hidden dims 32-512)."""
    from maua_tpu_torch.train.vae import train_vae

    model = cs.vae_model(0).cuda()
    batch = torch.rand((cs.VAE_BATCH, 3, cs.VAE_SIZE, cs.VAE_SIZE), device="cuda") * 2 - 1
    fwd, _ = cs.record_launch_shapes(lambda: train_vae(model, itertools.repeat(batch), n_steps=1, log_every=100))
    del model
    return sorted((shape, with_bias, n) for (shape, dtype, with_bias), n in fwd.items())


def phase_vae(fns: dict, shapes: list) -> dict:
    g = torch.Generator(device="cuda").manual_seed(1)
    impl = {"old": fns["old"], "current": fns["current"], "plain": fused_leaky_relu_plain}
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        step = {f"{k}_{t}": 0.0 for k in impl for t in ("sleep", "nosleep")}
        step["bound"] = 0.0
        for shape, with_bias, n in shapes:
            x, b = inputs(shape, dtype, with_bias, g)
            row = dict(shape=list(shape), dtype=dname, launches_per_step=n, bound_ms=bound_ms(x, b))
            # mirrored order: old, current, plain, then plain, current, old; the mean of the two
            for t, cycles in (("sleep", 1_000_000), ("nosleep", 0)):
                first = {k: timer(lambda f=f: f(x, b), x.numel(), cycles) for k, f in impl.items()}
                second = {k: timer(lambda f=f: f(x, b), x.numel(), cycles) for k, f in reversed(list(impl.items()))}
                for k in impl:
                    row[f"{k}_{t}_ms"] = (first[k] + second[k]) / 2
                    step[f"{k}_{t}"] += n * row[f"{k}_{t}_ms"]
            step["bound"] += n * row["bound_ms"]
            emit(phase="vae_shape", **row)
        emit(phase="vae_step", dtype=dname, launches=sum(n for _, _, n in shapes), **{f"{k}_ms": v for k, v in step.items()})
        out[dname] = step
    return out


def phase_wide(fns: dict) -> list:
    g = torch.Generator(device="cuda").manual_seed(2)
    names = ["old", "current", "flat64"]
    rows = []
    for dtype, shape in list(itertools.product((torch.float32, torch.bfloat16), WIDE)) + [(torch.bfloat16, BIG)]:
        x, b = inputs(shape, dtype, True, g)
        first = {k: timer(lambda k=k: fns[k](x, b), x.numel(), 1_000_000) for k in names}
        second = {k: timer(lambda k=k: fns[k](x, b), x.numel(), 1_000_000) for k in reversed(names)}
        bound = bound_ms(x, b)
        row = dict(shape=list(shape), dtype=str(dtype).split(".")[1], bound_ms=bound)
        for k in names:
            row[f"{k}_ms"] = (first[k] + second[k]) / 2
            row[f"{k}_ms_pair"] = [first[k], second[k]]
            row[f"{k}_bound_share"] = bound / row[f"{k}_ms"]
        emit(phase="wide", **row)
        rows.append(row)
        del x
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="an older fused_bias_act.cu to hold the current launcher against")
    ap.add_argument("--out", default="output/probe_fused_bias_act.json")
    ap.add_argument("--workdir", default="maua_tpu_torch/_build/probe")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_fused_bias_act.py needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    fns = {k: caller(lib) for k, lib in build_all(args.old, args.workdir).items()}
    check(fns)
    shapes = vae_step_shapes()
    emit(phase="vae_shapes", shapes=[[list(s), wb, n] for s, wb, n in shapes])
    result = dict(card=card, vae_step=phase_vae(fns, shapes), wide=phase_wide(fns))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

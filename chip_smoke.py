#!/usr/bin/env python3
"""Drive the maua_tpu_torch port on one CUDA card and check it.

    python3 chip_smoke.py        # from the repo root, on a machine with a CUDA card

Phases, each printing JSON lines:
  1. card and build: nvidia-smi's name and power limit, then nvcc builds every
     kernel of maua_tpu_torch/csrc (seconds, registers);
  2. kernels against their plain PyTorch versions at the main path's shapes,
     fp32 and bf16, with CUDA-event times (median of 25), the memory bound and
     the largest error;
  3. generator, card against CPU: a full-width 256^2 checkpoint made from a
     numpy seed, same W+ latents and noise, exact fp32, max abs <= 1e-3;
  4. the main path at full width: a random-weight checkpoint of the
     rosinality FFHQ-1024 configuration -> load_generator -> mean_latent ->
     render() of 48 frames at batch 8 into an mp4, with tensor truncation and
     an explicit noise timeline up to 256 wide. The launch counters are set to
     0 just before and read just after; the fused bias + leaky-ReLU kernel must
     have run exactly 8 (mapping) + 17 x 6 (render batches) times. Then
     frames/s for fp32 exact, fp32 fast and bf16, and the top CUDA ops of one
     1024^2 batch from torch.profiler.
The last line is {"ok": true, "device": {...}}. Any failure exits non-zero
before it; without a CUDA card, or without the package beside this file, the
script fails at once.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published peak
STYLE_DIM, N_MLP, CHANNEL_MULTIPLIER = 512, 8, 2


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def cuda_ms(fn, runs: int = 25, warmup: int = 3) -> float:
    """Median device time of fn() in ms, one pair of CUDA events per run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, reps: int = 10, runs: int = 25) -> float:
    """Median device time of one fn() in ms: `reps` back-to-back calls are
    captured in a CUDA graph and replayed, so no host launch latency sits
    between them (eager timing of a small kernel measures the host instead)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, runs) / reps


# ---------------------------------------------------------------- phase 2
def bias_act_case(shape, dtype, with_bias, seed=0):
    """Kernel vs plain on one input.

    Returns a dict: max_abs_err vs plain, max_abs_err_fp32_once vs the fp32
    result rounded once, kernel_ms / plain_ms (device time, graph replay),
    eager_ms / plain_eager_ms (one eager call, host launch included), bound_ms. fp32: rtol = atol = 1e-6. bf16: two
    bf16 ulps (rtol 1.6e-2, atol 1e-2). For bf16 the bias is drawn
    bf16-representable: the plain form casts the bias to bf16 before the add,
    which for an fp32 bias of |b| ~ 4 alone moves a result near zero by up to
    scale * |b| * 2^-9 ~ 0.011; the kernel reads the bias in fp32 and rounds
    once, on the store."""
    from maua_tpu_torch.ops.fused_act import fused_bias_act, fused_leaky_relu_plain

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    channels = shape[1] if len(shape) >= 3 else shape[-1]
    b = torch.randn(channels, generator=g, device="cuda").to(dtype).float() if with_bias else None
    got = fused_bias_act(x, b)
    torch.cuda.synchronize()
    want = fused_leaky_relu_plain(x, b)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == torch.float32 else dict(rtol=1.6e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    err = (got.float() - want.float()).abs().max().item()
    once = fused_leaky_relu_plain(x.float(), b).to(dtype)
    err_once = (got.float() - once.float()).abs().max().item()
    moved = 2 * x.numel() * x.element_size() + (0 if b is None else 4 * channels)
    return dict(
        max_abs_err=err,
        max_abs_err_fp32_once=err_once,
        kernel_ms=graph_ms(lambda: fused_bias_act(x, b)),
        plain_ms=graph_ms(lambda: fused_leaky_relu_plain(x, b)),
        eager_ms=cuda_ms(lambda: fused_bias_act(x, b)),
        plain_eager_ms=cuda_ms(lambda: fused_leaky_relu_plain(x, b)),
        bound_ms=moved / HBM_BYTES_PER_S * 1e3,
    )


def render_batch_shapes(batch: int, size: int = 1024):
    """(shape, count) of the StyledConv outputs of one forward from W+."""
    from maua_tpu_torch.models import channel_map

    ch = channel_map(CHANNEL_MULTIPLIER)
    shapes = [((batch, ch[4], 4, 4), 1)]
    res = 8
    while res <= size:
        shapes.append(((batch, ch[res], res, res), 2))
        res *= 2
    return shapes


def phase_kernels():
    for dtype in (torch.float32, torch.bfloat16):
        for shape, with_bias in [  # (16384, 512): mean_latent's mapping layers
            ((8, 512), True), ((16384, 512), True), ((8, 512, 4, 4), True), ((8, 512, 64, 64), True),
            ((8, 32, 1024, 1024), True), ((3, 130), True), ((8, 512, 64, 64), False),
        ]:
            emit(phase="kernel", kernel="fused_bias_act", shape=list(shape), dtype=str(dtype).split(".")[1],
                 bias=with_bias, **bias_act_case(shape, dtype, with_bias), bound_by="bytes", library_ms=None)
    # one render batch at 1024^2 x 8: the 17 launches of a forward from W+
    per_batch = {}
    for dtype in (torch.float32, torch.bfloat16):
        tot = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, launches=0)
        for shape, count in render_batch_shapes(8):
            case = bias_act_case(shape, dtype, True)
            tot["max_abs_err"] = max(tot["max_abs_err"], case["max_abs_err"])
            tot["ms"] += count * case["kernel_ms"]
            tot["plain_ms"] += count * case["plain_ms"]
            tot["bound_ms"] += count * case["bound_ms"]
            tot["launches"] += count
        name = str(dtype).split(".")[1]
        emit(phase="kernel_render_batch", kernel="fused_bias_act", dtype=name, batch=8, size=1024, **tot)
        per_batch[name] = tot
    return per_batch


# ---------------------------------------------------------------- phases 3, 4
def fabricate_checkpoint(path: str, size: int, seed: int) -> None:
    """A rosinality-format g_ema of the full-width config, weights from numpy:
    N(0,1) weights (mapping weights / lr_mul, as rosinality initialises them),
    modulation biases near 1, small random biases and noise weights."""
    from maua_tpu_torch.models import Generator

    template = Generator(size=size, style_dim=STYLE_DIM, n_mlp=N_MLP,
                         channel_multiplier=CHANNEL_MULTIPLIER, constant_input=True)
    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in template.state_dict().items():
        if name.endswith(".kernel"):
            sd[name] = t
            continue
        v = rng.standard_normal(tuple(t.shape), dtype=np.float32)
        if name.startswith("style.") and name.endswith(".weight"):
            v = v / 0.01
        elif name.endswith("modulation.bias"):
            v = 1.0 + 0.1 * v
        elif name.endswith(".bias") or name.endswith("noise.weight"):
            v = 0.1 * v
        sd[name] = torch.from_numpy(v)
    torch.save({"g_ema": sd}, path)


def noise_list(gen, n: int, rng, max_width=None):
    return [
        None if max_width is not None and s[3] > max_width
        else rng.standard_normal((n, 1, s[2], s[3]), dtype=np.float32)
        for s in (tuple(getattr(gen.noises, f"noise_{i}").shape) for i in range(gen.num_layers))
    ]


def phase_card_vs_cpu(tmp: str):
    from maua_tpu_torch.io import load_generator

    path = os.path.join(tmp, "g256.pt")
    fabricate_checkpoint(path, 256, seed=1)
    card = load_generator(path, device="cuda")
    cpu = load_generator(path, device="cpu")
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((2, card.n_latent, STYLE_DIM), dtype=np.float32))
    noise = noise_list(card, 2, rng)
    with torch.inference_mode():
        a, _ = card(w.cuda(), input_is_latent=True, randomize_noise=False,
                    noise=[torch.from_numpy(n).cuda() for n in noise])
        b, _ = cpu(w, input_is_latent=True, randomize_noise=False, noise=[torch.from_numpy(n) for n in noise])
    err = (a.cpu() - b).abs().max().item()
    emit(phase="card_vs_cpu", size=256, style_dim=STYLE_DIM, n_mlp=N_MLP, channel_multiplier=CHANNEL_MULTIPLIER,
         precision="exact", max_abs_err=err, image_abs_max=b.abs().max().item())
    require(bool(torch.isfinite(a).all()), "256^2 card image is finite")
    require(err <= 1e-3, f"card vs CPU at 256^2: max abs {err} > 1e-3")


def synth_fps(gen, latents, noise, trunc, tl, batch: int, batches: int = 5) -> float:
    """Frames/s of synthesis + uint8 packing on the card (no host copy)."""
    from maua_tpu_torch.render.frames import _pack_frames

    def one(k):
        sl = slice(k * batch, (k + 1) * batch)
        img, _ = gen(latents[sl], input_is_latent=True, randomize_noise=False,
                     noise=[None if n is None else n[sl] for n in noise],
                     truncation=trunc[sl], truncation_latent=tl)
        return _pack_frames(img, None)

    with torch.inference_mode():
        one(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(batches):
            one(k % (latents.shape[0] // batch))
        torch.cuda.synchronize()
    return batches * batch / (time.perf_counter() - t0)


def phase_main_path(tmp: str):
    from maua_tpu_torch.io import load_generator
    from maua_tpu_torch.ops import fused_act
    import maua_tpu_torch.render.frames as frames
    from maua_tpu_torch.render import VideoWriter, render

    class CountingWriter(VideoWriter):
        """The real writer, plus a count and the spread of what it wrote."""
        written: list = []
        backend_used = None

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            CountingWriter.backend_used = self.backend

        def write(self, frame):
            super().write(frame)
            CountingWriter.written.append(float(frame.std()))

    frames.VideoWriter = CountingWriter

    path = os.path.join(tmp, "g1024.pt")
    t0 = time.perf_counter()
    fabricate_checkpoint(path, 1024, seed=3)
    emit(phase="checkpoint", size=1024, seconds=time.perf_counter() - t0, bytes=os.path.getsize(path))

    n_frames, batch = 48, 8
    rng = np.random.default_rng(4)
    results = {}
    for label, kw in (("fp32_exact", {}), ("bf16", {"dtype": torch.bfloat16}), ("fp32_fast", {"precision": "fast"})):
        t0 = time.perf_counter()
        gen = load_generator(path, device="cuda", **kw)
        load_s = time.perf_counter() - t0
        z = torch.from_numpy(rng.standard_normal((n_frames, STYLE_DIM), dtype=np.float32)).cuda()
        with torch.inference_mode():
            latents = gen.map_latents(z)  # set-up: the selection a user's plugin would make
        noise = noise_list(gen, n_frames, rng, max_width=256)  # get_noise's rule: None above 256 wide
        trunc = np.linspace(0.5, 1.0, n_frames, dtype=np.float32)
        out = os.path.join(tmp, f"{label}.mp4")
        render(gen, None, latents[:batch], noise=[None if n is None else n[:batch] for n in noise],
               output_file=os.path.join(tmp, "warmup.mp4"), batch_size=batch, fps=24,
               truncation=trunc[:batch], truncation_latent=gen.mean_latent(torch.Generator("cuda").manual_seed(0)))
        torch.cuda.synchronize()
        CountingWriter.written = []

        # ---- the main path, counted ----
        fused_act.launches = 0
        t0 = time.perf_counter()
        tl = gen.mean_latent(torch.Generator(device="cuda").manual_seed(5))
        render(gen, None, latents, noise, out, batch_size=batch, fps=24, truncation=trunc, truncation_latent=tl)
        render_s = time.perf_counter() - t0
        launches = fused_act.launches

        expected = N_MLP + 17 * (n_frames // batch)
        require(len(CountingWriter.written) == n_frames, f"{label}: {len(CountingWriter.written)} frames written")
        require(min(CountingWriter.written) > 0, f"{label}: a written frame is constant")
        require(launches == expected, f"{label}: fused_bias_act launched {launches} times, expected {expected}")
        lat_d = latents
        noise_d = [None if n is None else torch.from_numpy(n).cuda() for n in noise]
        trunc_d = torch.from_numpy(trunc).cuda()
        with torch.inference_mode():
            img, _ = gen(lat_d[:batch], input_is_latent=True, randomize_noise=False,
                         noise=[None if n is None else n[:batch] for n in noise_d],
                         truncation=trunc_d[:batch], truncation_latent=tl)
        require(tuple(img.shape) == (batch, 3, 1024, 1024), f"{label}: image shape {tuple(img.shape)}")
        require(bool(torch.isfinite(img).all()), f"{label}: image is finite")
        fps = synth_fps(gen, lat_d, noise_d, trunc_d, tl, batch)
        results[label] = dict(launches=launches, render_fps=n_frames / render_s, synth_fps=fps)
        emit(phase="main_path", config=label, size=1024, style_dim=STYLE_DIM, n_mlp=N_MLP,
             channel_multiplier=CHANNEL_MULTIPLIER, frames=n_frames, batch=batch, launches=launches,
             expected_launches=expected, load_seconds=load_s, render_seconds=render_s,
             render_fps=n_frames / render_s, synth_fps=fps, writer=CountingWriter.backend_used,
             image_abs_max=img.abs().max().item())
        if label in ("fp32_exact", "bf16"):
            profile_batch(gen, lat_d, noise_d, trunc_d, tl, batch, label, batch_ms=1e3 * batch / fps)
        del gen
        torch.cuda.empty_cache()
    return results


def profile_batch(gen, latents, noise, trunc, tl, batch: int, label: str, batch_ms: float) -> None:
    """Top 10 CUDA kernels by device time over one 1024^2 batch; the busy
    share is their sum over the wall time of an unprofiled batch (batch_ms)."""
    from torch.profiler import ProfilerActivity, profile

    from maua_tpu_torch.render.frames import _pack_frames

    def one():
        img, _ = gen(latents[:batch], input_is_latent=True, randomize_noise=False,
                     noise=[None if n is None else n[:batch] for n in noise],
                     truncation=trunc[:batch], truncation_latent=tl)
        return _pack_frames(img, None)

    with torch.inference_mode():
        one()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            one()
            torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):  # kernels only; op rows would count twice
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, ev.key[:160], ev.count))
    rows.sort(reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    require(total_ms > 0, "the profiler saw device time")
    emit(phase="profile", config=label, size=1024, batch=batch, kernel_ms_total=total_ms,
         unprofiled_batch_ms=batch_ms, device_busy_share=total_ms / batch_ms, kernels=len(rows),
         top=[dict(kernel=k, device_ms=us / 1e3, share=us / 1e3 / total_ms, calls=c) for us, k, c in rows[:10]])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(os.path.dirname(os.path.abspath(__file__)), "maua_tpu_torch")):
        print("chip_smoke: maua_tpu_torch/ is not beside this script; run it from the repo root", file=sys.stderr)
        return 1
    from maua_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(phase="env", python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)

    t0 = time.perf_counter()
    libs = _build.build()
    regs = {name: [line.split("Used ")[1] for line in path.with_suffix(".log").read_text().splitlines()
                   if "Used " in line] for name, path in libs.items()}
    emit(phase="build", seconds=time.perf_counter() - t0, libraries=sorted(libs), ptxas=regs)

    per_batch = phase_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        phase_card_vs_cpu(tmp)
        results = phase_main_path(tmp)

    fp32 = per_batch["float32"]
    print(json.dumps({"kernels": [{
        "name": "fused_bias_act",
        "route": "cuda",
        "source": "maua_tpu_torch/csrc/fused_bias_act.cu",
        "replaces": "maua_tpu/ops/pallas_act.py:38",
        "launches": results["fp32_exact"]["launches"],
        "max_abs_err": fp32["max_abs_err"],
        "ms": fp32["ms"],
        "plain_ms": fp32["plain_ms"],
        "bound_ms": fp32["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

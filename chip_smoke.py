#!/usr/bin/env python3
"""Drive the maua_tpu_torch port on one CUDA card and check it.

    python3 chip_smoke.py        # from the repo root, on a machine with a CUDA card

Phases, each printing JSON lines:
  1. card and build: nvidia-smi's name and power limit, then nvcc builds every
     kernel of maua_tpu_torch/csrc (seconds, registers);
  2. kernels against their plain PyTorch versions at the main paths' shapes,
     fp32 and bf16, with CUDA-event times (median of 25), the memory bound and
     the largest error: the fused bias + leaky-ReLU forward at the render
     shapes (`kernel`, `kernel_render_batch`) and its gradient kernel at the
     training shapes (`kernel_grad`), plus first-order (dx, db) and the grad
     of a grad-norm through the two autograd Functions on the card against
     plain autograd;
  3. generator, card against CPU: a full-width 256^2 checkpoint made from a
     numpy seed, same W+ latents and noise, exact fp32, max abs <= 1e-3;
  4. the render path at full width: a random-weight checkpoint of the
     rosinality FFHQ-1024 configuration -> load_generator -> mean_latent ->
     render() of 48 frames at batch 8 into an mp4, with tensor truncation and
     an explicit noise timeline up to 256 wide. The launch counters are set to
     0 just before and read just after; the forward kernel must have run
     exactly 8 (mapping) + 17 x 6 (render batches) times. Then frames/s for
     fp32 exact, fp32 fast and bf16, and the top CUDA ops of one 1024^2 batch
     from torch.profiler;
  5. training, card against CPU (`train_card_vs_cpu`): a narrow model (32^2,
     channel_max 64, batch 4), each phase of a step with R1 and the path
     penalty due, from the same weights and the same explicit draws, exact
     fp32 on both;
  6. the training path at full width (`train_main_path`): synthetic raw
     shards at 256^2 -> the train CLI's parser -> train_loop (channel
     multiplier 2, channel_max 512, constant input, batch 12, --no-augment,
     lookahead on) for 8 steps in fp32 exact and again in bf16. The counters
     are set to 0 just before each run and read just after; every step's
     launches of both kernels must equal the counts derived from the model's
     structure. s/step by kind of step, imgs/s, per-phase CUDA-event times,
     peak memory; the checkpoint's g_ema goes through load_generator and
     render(); R1's gradients with upfirdn2d's autograd Function against
     autograd of its depthwise conv (`r1_upfirdn2d_autograd`, fp32);
     torch.profiler over one step with R1 and the path penalty and over one
     plain step;
  7. generate(), card against CPU (`generate_card_vs_cpu`): on a 20 s track
     made from a numpy seed, the onset function, the default plugin's onset
     envelopes, chroma and latents (latent file set), every bend transform,
     and one generate() at 256^2 full width with numpy noise and truncation 1;
  8. generate() at full width (`generate_preprocess`, `generate_main_path`):
     (a) the default plugin over a 180 s track at 30 fps, seconds per
     function, timeline bytes, peak memory and the staging round trip;
     (b) generate() of a 12 s window of the FFHQ-1024 configuration at batch
     8, truncation 0.75, a translate bend on layer 4 driven by the high
     onsets; (c) the tauceti example plugin at out_size 1920 for 2 s. The
     counters are set to 0 just before (b) and (c) and read just after: 8
     (generate_latents) + 8 if truncated (mean_latent) + 17 per batch
     forward launches. Then the forward kernel against its plain version at
     the launch shapes of (b) and (c) not held before (`kernel_generate`).
The line before the last lists both kernels (`kernels`); the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before it; without
a CUDA card, or without the package beside this file, the script fails at
once.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import math
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


def install_counting_writer():
    """Replace render()'s writer with the real writer plus a count and the
    spread of each frame it wrote; returns the class."""
    import maua_tpu_torch.render.frames as frames
    from maua_tpu_torch.render import VideoWriter

    if getattr(frames.VideoWriter, "counting", False):
        return frames.VideoWriter

    class CountingWriter(VideoWriter):
        counting = True
        written: list = []
        backend_used = None

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            CountingWriter.backend_used = self.backend

        def write(self, frame):
            super().write(frame)
            CountingWriter.written.append(float(frame.std()))

    frames.VideoWriter = CountingWriter
    return CountingWriter


def phase_main_path(tmp: str):
    from maua_tpu_torch.io import load_generator
    from maua_tpu_torch.ops import fused_act
    from maua_tpu_torch.render import render

    CountingWriter = install_counting_writer()

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
        fused_act.launches = fused_act.grad_launches = 0
        t0 = time.perf_counter()
        tl = gen.mean_latent(torch.Generator(device="cuda").manual_seed(5))
        render(gen, None, latents, noise, out, batch_size=batch, fps=24, truncation=trunc, truncation_latent=tl)
        render_s = time.perf_counter() - t0
        launches = fused_act.launches

        expected = N_MLP + 17 * (n_frames // batch)
        require(len(CountingWriter.written) == n_frames, f"{label}: {len(CountingWriter.written)} frames written")
        require(min(CountingWriter.written) > 0, f"{label}: a written frame is constant")
        require(launches == expected, f"{label}: fused_bias_act launched {launches} times, expected {expected}")
        require(fused_act.grad_launches == 0, f"{label}: render launched the gradient kernel")
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


def kernel_rows(prof) -> list:
    """(device us, name, calls) of each CUDA kernel of a profile, largest
    first; fails if the profiler saw no device time."""
    rows = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):  # kernels only; op rows would count twice
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, ev.key[:160], ev.count))
    require(bool(rows), "the profiler saw device time")
    return sorted(rows, reverse=True)


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
    rows = kernel_rows(prof)
    total_ms = sum(r[0] for r in rows) / 1e3
    emit(phase="profile", config=label, size=1024, batch=batch, kernel_ms_total=total_ms,
         unprofiled_batch_ms=batch_ms, device_busy_share=total_ms / batch_ms, kernels=len(rows),
         top=[dict(kernel=k, device_ms=us / 1e3, share=us / 1e3 / total_ms, calls=c) for us, k, c in rows[:10]])


# ---------------------------------------------------------------- phases 5, 6: training
TRAIN_SIZE, TRAIN_BATCH, TRAIN_STEPS = 256, 12, 8


def train_config(bf16: bool, **over):
    from maua_tpu_torch.train import make_train_config

    kw = dict(size=TRAIN_SIZE, batch_size=TRAIN_BATCH, channel_multiplier=CHANNEL_MULTIPLIER, channel_max=512,
              constant_input=True, augment=False, lookahead=True, bf16=bf16)
    kw.update(over)
    return make_train_config(**kw)


def expected_launches(cfg, step: int) -> tuple[int, int]:
    """(forward, gradient) kernel launches of train step `step`, from the
    model's structure. One G synthesis from mixed z runs S = 2 x n_mlp (z1 and
    z2 mapped) + n_layers StyledConv activations (+ 2 for a latent-mapped
    input); one D forward runs Dn = from_rgb + 2 per ResBlock + final_conv +
    final_linear.0. A first-order backward launches the gradient kernel once
    per activation it passes. R1's double backward passes every D activation
    twice more (the gate applied to the tangent, and the forward node again,
    reached through the conv double-backward's edge to its input), so 3 x Dn;
    the path penalty's first backward stops at W+ (n_layers), its second
    passes the StyledConvs twice more and the mapping network once:
    3 x n_layers + 2 x n_mlp."""
    n_mlp = 8
    log_size = int(math.log2(cfg.size))
    latent_in = 0 if cfg.constant_input else 2
    n_layers = 2 * (log_size - 2) + 1 + latent_in
    synth = 2 * n_mlp + n_layers
    disc = 1 + 2 * (log_size - 2) + 1 + 1
    a, k = cfg.num_accumulate, max(1, cfg.reg_chunks)
    fwd = a * (synth + disc) * 2  # D phase (G without grad, D) and G phase (G, D)
    grad = a * disc + a * (disc + synth)
    if cfg.r1 > 0 and step % cfg.d_reg_every == 0:
        fwd, grad = fwd + a * k * disc, grad + a * k * 3 * disc
    if cfg.path_regularize > 0 and step % cfg.g_reg_every == 0:
        fwd, grad = fwd + a * k * synth, grad + a * k * (3 * n_layers + 2 * n_mlp)
    return fwd, grad


def step_kind(cfg, step: int) -> str:
    r1 = step % cfg.d_reg_every == 0
    path = step % cfg.g_reg_every == 0
    return "r1_path" if r1 and path else ("path" if path else ("r1" if r1 else "plain"))


def record_launch_shapes(fn):
    """Run fn() with the two kernel wrappers wrapped to record each launch's
    (shape, dtype[, bias]); returns (forward Counter, gradient Counter). The
    wrappers still launch and count."""
    from collections import Counter

    from maua_tpu_torch.ops import fused_act

    fwd, grad = Counter(), Counter()
    real_fwd, real_grad = fused_act.fused_bias_act, fused_act.fused_bias_act_grad

    def rec_fwd(x, bias=None, *a, **k):
        fwd[(tuple(x.shape), str(x.dtype).split(".")[1], bias is not None)] += 1
        return real_fwd(x, bias, *a, **k)

    def rec_grad(dy, y, *a, **k):
        grad[(tuple(dy.shape), str(dy.dtype).split(".")[1])] += 1
        return real_grad(dy, y, *a, **k)

    fused_act.fused_bias_act, fused_act.fused_bias_act_grad = rec_fwd, rec_grad
    try:
        fn()
    finally:
        fused_act.fused_bias_act, fused_act.fused_bias_act_grad = real_fwd, real_grad
    return fwd, grad


def fast_ms(fn, numel: int) -> float:
    """graph_ms with fewer replays for the largest tensors."""
    return graph_ms(fn, reps=10, runs=25) if numel < 2**24 else graph_ms(fn, reps=3, runs=10)


def grad_case(shape, dtype, seed=0):
    """Gradient kernel vs plain on one input: exact (both compute the gain and
    the product in fp32 and round once). Times as in bias_act_case; the bound
    reads dy and y and writes dx. `leaky_relu_backward_ms` times
    torch.ops.aten.leaky_relu_backward on the same inputs, a near yardstick
    only: it moves the same bytes but has no scale, so it is not the same
    function."""
    from maua_tpu_torch.ops.fused_act import fused_bias_act_grad, fused_bias_act_grad_plain

    g = torch.Generator(device="cuda").manual_seed(seed)
    dy = torch.randn(shape, generator=g, device="cuda").to(dtype)
    y = torch.randn(shape, generator=g, device="cuda").to(dtype)
    got = fused_bias_act_grad(dy, y)
    torch.cuda.synchronize()
    err = (got.float() - fused_bias_act_grad_plain(dy, y).float()).abs().max().item()
    require(err == 0.0, f"gradient kernel {list(shape)} {dtype}: max abs {err} against the plain form")
    n = dy.numel()
    return dict(
        max_abs_err=err,
        kernel_ms=fast_ms(lambda: fused_bias_act_grad(dy, y), n),
        plain_ms=fast_ms(lambda: fused_bias_act_grad_plain(dy, y), n),
        leaky_relu_backward_ms=fast_ms(lambda: torch.ops.aten.leaky_relu_backward(dy, y, 0.2, True), n),
        bound_ms=3 * n * dy.element_size() / HBM_BYTES_PER_S * 1e3,
    )


def phase_functions_on_card():
    """First-order (dx, db) and the grad of a grad-norm through the two
    autograd Functions on the card, against plain autograd of
    fused_leaky_relu_plain on the same card, fp32: rtol = atol = 1e-5."""
    from maua_tpu_torch.ops.fused_act import fused_leaky_relu, fused_leaky_relu_plain

    worst = 0.0
    for shape in ((TRAIN_BATCH, 512), (2 * TRAIN_BATCH, 128, 64, 64), (TRAIN_BATCH, 512, 8, 8)):
        g = torch.Generator(device="cuda").manual_seed(7)
        x = torch.randn(shape, generator=g, device="cuda")
        b = torch.randn(shape[1] if len(shape) >= 3 else shape[-1], generator=g, device="cuda")
        outs = []
        for fn in (fused_leaky_relu, fused_leaky_relu_plain):
            xt, bt = x.clone().requires_grad_(), b.clone().requires_grad_()
            first = torch.autograd.grad((fn(xt, bt) ** 2).sum(), [xt, bt], create_graph=True)
            second = torch.autograd.grad((first[0] ** 2).sum(), [xt, bt])
            outs.append([t.detach() for t in first + second])
        for got, want in zip(*outs):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            worst = max(worst, (got - want).abs().max().item())
    emit(phase="functions_on_card", checks=["dx", "db", "d(|dx|^2)/dx", "d(|dx|^2)/db"], dtype="float32",
         max_abs_err=worst, tolerance="rtol=atol=1e-5")


def phase_kernels_train(shapes: dict) -> dict:
    """Both kernels at every launch shape of one fp32 / bf16 train step with
    R1 and the path penalty (recorded on the main path), kernel vs plain;
    totals per step weight each shape by its launches."""
    per_step = {}
    for label, (fwd, grad) in shapes.items():
        tot = {"fused_bias_act": dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, launches=0),
               "fused_bias_act_grad": dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, launches=0,
                                           leaky_relu_backward_ms=0.0)}
        for (shape, dtype, with_bias), count in sorted(fwd.items()):
            case = bias_act_case(shape, getattr(torch, dtype), with_bias)
            t = tot["fused_bias_act"]
            t["max_abs_err"] = max(t["max_abs_err"], case["max_abs_err"])
            t["ms"] += count * case["kernel_ms"]
            t["plain_ms"] += count * case["plain_ms"]
            t["bound_ms"] += count * case["bound_ms"]
            t["launches"] += count
        for (shape, dtype), count in sorted(grad.items()):
            case = grad_case(shape, getattr(torch, dtype))
            emit(phase="kernel_grad", kernel="fused_bias_act_grad", shape=list(shape), dtype=dtype, launches_per_step=count,
                 **case, bound_by="bytes")
            t = tot["fused_bias_act_grad"]
            t["max_abs_err"] = max(t["max_abs_err"], case["max_abs_err"])
            t["ms"] += count * case["kernel_ms"]
            t["plain_ms"] += count * case["plain_ms"]
            t["bound_ms"] += count * case["bound_ms"]
            t["leaky_relu_backward_ms"] += count * case["leaky_relu_backward_ms"]
            t["launches"] += count
        for name, t in tot.items():
            emit(phase="kernel_train_step", kernel=name, config=label, step_kind="r1_path", size=TRAIN_SIZE,
                 batch=TRAIN_BATCH, **t)
        per_step[label] = tot
    return per_step


def phase_train_card_vs_cpu():
    """Each phase of a step with R1 and the path penalty due, on the card
    (exact fp32) and on the CPU, from the same weights (init_train_state draws
    them on the CPU from the seed) and the same draws (made on the CPU and
    copied). Tolerance: losses rtol 1e-4; each gradient tensor max abs <=
    1e-3 x its max abs + 1e-6. Both sides are fp32 with TF32 off; they differ
    in the order of the convolutions' sums (cuDNN against oneDNN), which the
    double backward of R1 and the path penalty amplifies."""
    from maua_tpu_torch.train import draw_step, init_train_state, make_train_config, make_train_phases

    cfg = make_train_config(size=32, channel_max=64, batch_size=4, augment=False, constant_input=True)
    draws = draw_step(cfg, 0, torch.Generator().manual_seed(3), "cpu")
    real = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (1, 4, 3, 32, 32)).astype(np.float32))

    def to(obj, device):
        if isinstance(obj, torch.Tensor):
            return obj.to(device)
        if isinstance(obj, list):
            return [to(o, device) for o in obj]
        return type(obj)(**{k: to(v, device) for k, v in vars(obj).items()})

    out = {}
    for name in ("d", "r1", "g", "path"):
        res = {}
        for dev in ("cpu", "cuda"):
            st = init_train_state(cfg, seed=1, device=dev)
            ph = make_train_phases(cfg)
            arg = {"d": (to(real, dev), to(draws.d, dev)), "r1": (to(real, dev),), "g": (to(draws.g, dev),),
                   "path": (to(draws.path, dev),)}[name]
            aux, grads = ph[name](st, *arg)
            loss = aux["d_loss"] if name == "d" else aux
            res[dev] = (float(loss), [g.detach().cpu() for g in grads])
        (l_cpu, g_cpu), (l_card, g_card) = res["cpu"], res["cuda"]
        worst = max(((a - b).abs().max() / (b.abs().max() + 1e-12)).item() for a, b in zip(g_card, g_cpu))
        max_abs = max((a - b).abs().max().item() for a, b in zip(g_card, g_cpu))
        out[name] = dict(loss_cpu=l_cpu, loss_card=l_card, grad_max_abs_err=max_abs, grad_max_rel_err=worst)
        require(abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu) + 1e-7, f"{name} loss: card {l_card} vs CPU {l_cpu}")
        for a, b in zip(g_card, g_cpu):
            require(bool(torch.isfinite(a).all()), f"{name}: card gradient is finite")
            require((a - b).abs().max().item() <= 1e-3 * b.abs().max().item() + 1e-6, f"{name}: card vs CPU gradient")
    emit(phase="train_card_vs_cpu", size=32, channel_max=64, batch=4, precision="exact fp32",
         tolerance="loss rtol 1e-4; grad max abs <= 1e-3 x max abs + 1e-6", phases=out)


def phase_train_main_path(tmp: str) -> dict:
    from maua_tpu_torch.data.synthetic import write_synth_shards
    from maua_tpu_torch.io import load_generator
    from maua_tpu_torch.ops import fused_act
    from maua_tpu_torch.render import render
    from maua_tpu_torch.train import draw_step, latest_checkpoint, make_train_phases, make_train_step
    from maua_tpu_torch.train.cli import build_parser, train_loop
    from maua_tpu_torch.train.step import prepare_reals

    shards = os.path.join(tmp, "shards")
    t0 = time.perf_counter()
    write_synth_shards(shards, TRAIN_SIZE, 48, fmt="raw", seed=0)
    emit(phase="train_data", size=TRAIN_SIZE, records=48, seconds=time.perf_counter() - t0)

    results, shapes = {}, {}
    for label, bf16 in (("fp32_exact", False), ("bf16", True)):
        cfg = train_config(bf16)

        def argv(run, iters):
            return ["--path", shards, "--size", str(TRAIN_SIZE), "--batch_size", str(TRAIN_BATCH),
                    "--channel_multiplier", str(CHANNEL_MULTIPLIER), "--channel_max", "512", "--no-augment",
                    "--iter", str(iters), "--log_every", "1", "--img_every", "0", "--checkpoint_every", "0",
                    "--num_workers", "4", "--device", "cuda", "--run_dir", run] + (["--bf16"] if bf16 else [])

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train_loop(build_parser().parse_args(argv(os.path.join(tmp, "cfg"), 1) + ["--print_config"]))
        resolved = json.loads(buf.getvalue())
        require(resolved == json.loads(json.dumps(cfg._asdict())), f"{label}: the CLI resolves another config: {resolved}")

        # warm-up: one step with R1 and the path penalty (cuDNN and allocator set-up)
        with contextlib.redirect_stdout(io.StringIO()):
            train_loop(build_parser().parse_args(argv(os.path.join(tmp, f"warm_{label}"), 1)))
        torch.cuda.synchronize()

        # ---- the main path, counted ----
        run = os.path.join(tmp, f"run_{label}")
        torch.cuda.reset_peak_memory_stats()
        fused_act.launches = fused_act.grad_launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            state = train_loop(build_parser().parse_args(argv(run, TRAIN_STEPS)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (fused_act.launches, fused_act.grad_launches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        lines = [json.loads(x) for x in open(os.path.join(run, "metrics.jsonl"))]
        require([x["step"] for x in lines] == list(range(TRAIN_STEPS)), f"{label}: logged steps {[x['step'] for x in lines]}")
        kinds: dict[str, list[float]] = {}
        for x in lines:
            for k in ("Generator", "Discriminator", "R1 Penalty", "Path Length Regularization", "Mean Path Length"):
                require(np.isfinite(x[k]), f"{label} step {x['step']}: {k} = {x[k]}")
            want = expected_launches(cfg, x["step"])
            got = (x["fused_bias_act launches"], x["fused_bias_act_grad launches"])
            require(got == want, f"{label} step {x['step']}: launches {got}, derived from the model {want}")
            kinds.setdefault(step_kind(cfg, x["step"]), []).append(x["sec_per_iter"])
        total = tuple(sum(expected_launches(cfg, i)[j] for i in range(TRAIN_STEPS)) for j in (0, 1))
        require(launches == total, f"{label}: {launches} launches in the run, derived {total}")
        require(set(kinds) == {"r1_path", "path", "plain"}, f"{label}: step kinds {sorted(kinds)}")
        s_step = {k: statistics.median(v) for k, v in kinds.items()}
        cycle = (s_step["r1_path"] + 3 * s_step["path"] + 12 * s_step["plain"]) / 16  # d_reg_every 16, g_reg_every 4
        per_kind = {k: dict(zip(("forward", "gradient"), expected_launches(cfg, i)))
                    for k, i in (("r1_path", 0), ("path", 4), ("plain", 1))}

        # checkpoint -> load_generator -> render(): training feeds the render path
        ckpt = latest_checkpoint(run)
        require(ckpt is not None and ckpt.endswith(f"step_{TRAIN_STEPS:07d}.pt"), f"{label}: checkpoint {ckpt}")
        gen = load_generator(ckpt, device="cuda", dtype=torch.bfloat16 if bf16 else torch.float32)
        z = torch.from_numpy(np.random.default_rng(8).standard_normal((8, STYLE_DIM), dtype=np.float32)).cuda()
        with torch.inference_mode():
            a, _ = gen(z, randomize_noise=False)
            b, _ = state.g_ema(z, randomize_noise=False)
            latents = gen.map_latents(z)
        require(bool(torch.isfinite(a).all()) and tuple(a.shape) == (8, 3, TRAIN_SIZE, TRAIN_SIZE), f"{label}: g_ema image")
        # same weights, two module instances: cuDNN may pick another conv
        # algorithm for each (its choice depends on the free workspace), so
        # the same sums in another order
        g_ema_err = (a - b).abs().max().item()
        require(g_ema_err <= 1e-4 * b.abs().max().item(), f"{label}: the loaded g_ema differs from the trained one by {g_ema_err}")
        writer = install_counting_writer()
        writer.written = []
        render(gen, None, latents, [], os.path.join(tmp, f"g_ema_{label}.mp4"), batch_size=8, fps=24, device="cuda")
        require(len(writer.written) == 8 and min(writer.written) > 0, f"{label}: g_ema render wrote {len(writer.written)}")

        # per-phase device time, and the launch shapes of one step with R1 and path
        phases = make_train_phases(cfg)
        gen_draws = torch.Generator(device="cuda").manual_seed(11)
        u8 = torch.from_numpy(np.random.default_rng(9).integers(
            0, 256, (1, TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3), dtype=np.uint8)).cuda()
        real = prepare_reals(u8)
        draws = draw_step(cfg, 0, gen_draws, "cuda")
        with tf32_off():
            phase_ms = {
                "d": cuda_ms(lambda: phases["d"](state, real, draws.d), runs=3, warmup=0),
                "r1": cuda_ms(lambda: phases["r1"](state, real), runs=3, warmup=0),
                "g": cuda_ms(lambda: phases["g"](state, draws.g), runs=3, warmup=0),
                "path": cuda_ms(lambda: phases["path"](state, draws.path), runs=3, warmup=0),
                "tail": cuda_ms(lambda: phases["tail"](state), runs=3, warmup=0),
            }
        if not bf16:
            r1_with_autograd_upfirdn2d(state, real[0])
        step_fn = make_train_step(cfg)
        state.step = 16 * 10
        shapes[label] = record_launch_shapes(lambda: step_fn(state, u8, draw_step(cfg, state.step, gen_draws, "cuda")))
        profile = {kind: profile_train_step(step_fn, state, u8, cfg, gen_draws, label, first)
                   for kind, first in (("r1_path", 16 * 11), ("plain", 16 * 13 + 1))}

        results[label] = dict(launches=launches, s_step=s_step, cycle_s=cycle, wall_s=wall, peak_gb=peak_gb,
                              phase_ms=phase_ms, profile=profile)
        emit(phase="train_main_path", config=label, size=TRAIN_SIZE, batch=TRAIN_BATCH, channel_multiplier=CHANNEL_MULTIPLIER,
             channel_max=512, steps=TRAIN_STEPS, launches=dict(zip(("forward", "gradient"), launches)),
             launches_per_step_kind=per_kind, s_per_step=s_step, imgs_per_s={k: TRAIN_BATCH / v for k, v in s_step.items()},
             imgs_per_s_16_step_cycle=TRAIN_BATCH / cycle, run_wall_s=wall, peak_memory_gb=peak_gb,
             phase_device_ms=phase_ms, losses_last={k: lines[-1][k] for k in ("Generator", "Discriminator")},
             checkpoint=os.path.basename(ckpt), loaded_g_ema_max_abs_err=g_ema_err)
        del state, gen, phases, step_fn
        torch.cuda.empty_cache()
    return {"results": results, "shapes": shapes}


def r1_with_autograd_upfirdn2d(state, real) -> None:
    """R1's D gradients at full width, once through upfirdn2d's autograd
    Function and once with autograd differentiating its depthwise conv
    directly (the form the Function replaced, whose double backward computes
    the FIR filter's gradient one channel at a time): device time of each and
    the largest difference of the gradients, relative to the tensor's max
    abs (limit 1e-4: the same sums in another order)."""
    import importlib

    import maua_tpu_torch.models.blocks as blocks
    from maua_tpu_torch.train.losses import d_r1_penalty

    fir = importlib.import_module("maua_tpu_torch.ops.upfirdn2d")  # the package exports a function of that name

    def by_autograd(x, kernel, up=1, down=1, pad=(0, 0)):
        return fir._upfirdn2d(x, kernel.detach(), fir._as_pair(up), fir._as_pair(down), fir._as_pad(pad))

    params = list(state.d.parameters())

    def r1_grads():
        with tf32_off():
            grads = torch.autograd.grad(d_r1_penalty(state.d, real), params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]

    want = r1_grads()
    function_ms = cuda_ms(r1_grads, runs=3, warmup=0)
    blocks.upfirdn2d = by_autograd
    try:
        got = r1_grads()
        autograd_ms = cuda_ms(r1_grads, runs=2, warmup=0)
    finally:
        blocks.upfirdn2d = fir.upfirdn2d
    rel = max(((a - b).abs().max() / (b.abs().max() + 1e-30)).item() for a, b in zip(got, want))
    require(rel <= 1e-4, f"R1 gradients, autograd upfirdn2d against the Function: {rel}")
    emit(phase="r1_upfirdn2d_autograd", size=TRAIN_SIZE, batch=real.shape[0], precision="exact fp32",
         function_ms=function_ms, autograd_ms=autograd_ms, grad_max_rel_err=rel)


@contextlib.contextmanager
def tf32_off():
    """The policy the train step holds: TF32 off in cuDNN and cuBLAS."""
    from maua_tpu_torch.models.blocks import tf32

    with tf32(conv=False, matmul=False):
        yield


def profile_train_step(step_fn, state, u8, cfg, gen_draws, label: str, step: int) -> dict:
    """Top 10 CUDA kernels by device time over one train step of the kind of
    `step` (R1 and the path penalty due at 16k, neither at 16k + 1); the busy
    share is their sum over the wall time of an unprofiled step of the same
    kind (`step` itself; the profiled one is `step` + 16)."""
    from torch.profiler import ProfilerActivity, profile

    from maua_tpu_torch.train import draw_step

    state.step = step
    draws = draw_step(cfg, step, gen_draws, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_fn(state, u8, draws)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    state.step = step + 16
    draws = draw_step(cfg, state.step, gen_draws, "cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step_fn(state, u8, draws)
        torch.cuda.synchronize()
    rows = kernel_rows(prof)
    total_ms = sum(r[0] for r in rows) / 1e3
    ours = {k: sum(us for us, key, _ in rows if k in key) / 1e3 for k in ("fused_bias_act_kernel", "fused_bias_act_grad_kernel")}
    out = dict(kernel_ms_total=total_ms, unprofiled_step_ms=wall_ms, device_busy_share=total_ms / wall_ms,
               kernels=len(rows), fused_kernels_ms=ours,
               top=[dict(kernel=k, device_ms=us / 1e3, share=us / 1e3 / total_ms, calls=c) for us, k, c in rows[:10]])
    emit(phase="train_profile", config=label, size=TRAIN_SIZE, batch=TRAIN_BATCH, step_kind=step_kind(cfg, step), **out)
    return out


# ---------------------------------------------------------------- phases 7, 8: generate()
SR = 22050
GEN_SIZE, TRACK_S = 1024, 180.0  # the FFHQ-1024 checkpoint of phase 4; the whole track of (a)


def synth_track(seconds: float, seed: int, bpm: float = 120.0) -> np.ndarray:
    """A mono track at 22050 Hz from a numpy seed: a two-note chord that
    changes every 10 s, a decaying 55 Hz kick and a 1.5 kHz click on
    alternate beats at `bpm`, and a little white noise."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    chords = [(440.0, 659.25), (523.25, 784.0), (392.0, 587.33), (349.23, 523.25)]
    y = np.zeros(n)
    seg = 10 * SR
    for i, s in enumerate(range(0, n, seg)):
        f1, f2 = chords[i % len(chords)]
        y[s : s + seg] = 0.1 * np.sin(2 * np.pi * f1 * t[s : s + seg]) + 0.06 * np.sin(2 * np.pi * f2 * t[s : s + seg])
    period = int(SR * 60.0 / bpm)
    kick = 0.6 * np.sin(2 * np.pi * 55.0 * np.arange(4000) / SR) * np.exp(-np.arange(4000) / 800.0)
    click = np.hanning(200) * np.sin(2 * np.pi * 1500.0 * np.arange(200) / SR)
    for k, s in enumerate(range(period // 4, n - 4000, period)):
        if k % 2 == 0:
            y[s : s + 4000] += kick
        else:
            y[s : s + 200] += click
    y += 0.003 * np.random.default_rng(seed).standard_normal(n)
    return y.astype(np.float32)


def write_wav(path: str, y: np.ndarray) -> str:
    import scipy.io.wavfile

    scipy.io.wavfile.write(path, SR, (np.clip(y, -1.0, 1.0) * 32767).astype(np.int16))
    return path


@contextlib.contextmanager
def capture_frames(frames: list):
    """render()'s writer replaced by a sink that keeps the uint8 frames."""
    import maua_tpu_torch.render.frames as frames_mod

    class Sink:
        def __init__(self, output_file, width, height, fps, **kw):
            self.shape = (height, width, 3)

        def write(self, frame):
            require(frame.shape == self.shape, f"frame {frame.shape} != {self.shape}")
            frames.append(np.array(frame))

        def close(self):
            pass

    real = frames_mod.VideoWriter
    frames_mod.VideoWriter = Sink
    try:
        yield
    finally:
        frames_mod.VideoWriter = real


def numpy_noise(height, width, scale, num_scales, args):
    """get_noise from a numpy seed: the same timelines on every device."""
    if width > 64:
        return None
    return np.random.default_rng(scale).standard_normal((args.n_frames, 1, height, width)).astype(np.float32)


def plugin_args(audio: np.ndarray, device: str, fps: float = 30.0):
    import argparse

    return argparse.Namespace(audio=torch.from_numpy(audio).to(device), sr=SR, duration=len(audio) / SR,
                              n_frames=int(round(len(audio) / SR * fps)), fps=fps)


def phase_generate_card_vs_cpu(tmp: str) -> None:
    """generate()'s analysis and a whole generate() at 256^2, card against CPU
    in exact fp32 (TF32 off): the onset function on the 20 s track (max abs
    <= 1e-3 x its max), the default plugin's onset envelopes, chroma and
    latents (max abs <= 1e-3), every bend transform (max abs <= 1e-5), and
    the frames of generate() with a latent file, numpy noise and truncation
    1, so that no device RNG is involved (within 1 uint8 level). The track's
    kick keeps the low band's percussive part from falling silent, where the
    onset function's modified KL term would divide rounding noise by
    rounding noise."""
    import maua_tpu_torch.audio as ar
    from maua_tpu_torch.models.blocks import tf32
    from maua_tpu_torch.pipeline import defaults, generate
    from maua_tpu_torch.reactive import add_noise_bend, load_latents, pad_bend, rotate_bend, translate_bend, zoom_bend

    onsets_mod = importlib.import_module("maua_tpu_torch.audio.onsets")
    wav = write_wav(os.path.join(tmp, "track20.wav"), synth_track(20.0, seed=5))
    audio = ar.load_audio(wav, cache=False)[0]
    latent_file = os.path.join(tmp, "selection.npy")
    np.save(latent_file, 0.5 * np.random.default_rng(6).standard_normal((12, 14, STYLE_DIM)).astype(np.float32))  # n_latent of 256^2
    ar.set_SMF(1.0)
    out = {}

    with tf32(conv=False, matmul=False):
        for name, band in (("lo", dict(fmax=150.0)), ("hi", dict(fmin=500.0))):
            a = onsets_mod.madmom_onset_ensemble(torch.from_numpy(audio).cuda(), sr=SR, **band).cpu()
            b = onsets_mod.madmom_onset_ensemble(torch.from_numpy(audio), sr=SR, **band)
            out[f"onset_function_{name}_rel"] = ((a - b).abs().max() / b.abs().max()).item()
            require(out[f"onset_function_{name}_rel"] <= 1e-3, f"onset function {name}: {out[f'onset_function_{name}_rel']}")

        res = {}
        for dev in ("cpu", "cuda"):
            ar.set_device(dev)
            args = plugin_args(audio, dev)
            defaults.initialize(args)
            chroma = ar.chroma(args.audio, SR, args.n_frames)
            latents = defaults.get_latents(selection=load_latents(latent_file), args=args)
            res[dev] = dict(lo_onsets=args.lo_onsets.cpu(), hi_onsets=args.hi_onsets.cpu(), chroma=chroma.cpu(),
                            latents=latents.cpu())
        for k in res["cpu"]:
            out[k] = (res["cuda"][k] - res["cpu"][k]).abs().max().item()
            require(out[k] <= 1e-3, f"default plugin {k}: card vs CPU max abs {out[k]}")

    rng = np.random.default_rng(7)
    x = rng.standard_normal((8, 512, 8, 16)).astype(np.float32)  # layer 4 of a widescreen 1920 render
    mod = rng.uniform(0, 1, 8).astype(np.float32)
    bends = {
        "translate": translate_bend(4, mod),
        "translate_noise": translate_bend(4, mod, rng.standard_normal((1, 1, 8, 80)).astype(np.float32)),
        "zoom": zoom_bend(4, 0.5 + mod),
        "rotate": rotate_bend(4, 90 * mod),
        "add_noise": add_noise_bend(4, rng.standard_normal((1, 1, 8, 16)).astype(np.float32), mod),
        "pad_edge": pad_bend(0),
        "pad_reflect": pad_bend(0, (3, 5, 9, 1), "reflect"),
    }
    bend_err = {}
    for name, b in bends.items():
        got = b.transform(torch.from_numpy(x).cuda(), torch.from_numpy(mod).cuda()).cpu()
        want = b.transform(torch.from_numpy(x), torch.from_numpy(mod))
        bend_err[name] = (got - want).abs().max().item()
        require(bend_err[name] <= 1e-5, f"bend {name}: card vs CPU max abs {bend_err[name]}")

    frames = {}
    window = dict(offset=4.0, duration=2.0)
    for dev in ("cpu", "cuda"):
        frames[dev] = []
        with capture_frames(frames[dev]), contextlib.redirect_stdout(io.StringIO()):
            generate(os.path.join(tmp, "g256.pt"), wav, initialize=defaults.initialize, get_noise=numpy_noise,
                     latent_file=latent_file, G_res=256, out_size=256, fps=4, batch=4, truncation=1.0,
                     output_file=os.path.join(tmp, f"g256_{dev}.mp4"), device=dev, **window)
    a, b = (np.stack(frames[d]).astype(np.int16) for d in ("cuda", "cpu"))
    require(a.shape == b.shape == (8, 256, 256, 3), f"generate frames {a.shape} / {b.shape}")
    frame_err = int(np.abs(a - b).max())
    require(frame_err <= 1 and b.std() > 0, f"generate() at 256^2: card vs CPU frames differ by {frame_err} levels")
    emit(phase="generate_card_vs_cpu", track_seconds=20, precision="exact fp32", max_abs_err=out, bend_max_abs_err=bend_err,
         generate_size=256, generate_frames=len(frames["cuda"]), generate_max_level_diff=frame_err,
         tolerance="onset function 1e-3 x max; envelopes, chroma, latents 1e-3; bends 1e-5; frames 1 level")


def timed(fn):
    """(result, seconds) of fn() on the host clock, ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def staging_seconds(latents, noise) -> float:
    """render()'s timeline staging, alone: every timeline to host numpy and
    back to the card (render/frames.py `_host`, then `stage`)."""
    from maua_tpu_torch.render.frames import _host

    def round_trip():
        return [torch.from_numpy(_host(x)).cuda() for x in [latents, *noise] if x is not None]

    return timed(round_trip)[1]


def preprocess_breakdown(args) -> dict:
    """Seconds of the default plugin's stages on the card, one at a time."""
    import maua_tpu_torch.audio as ar
    from maua_tpu_torch.pipeline.defaults import _draw

    hpss, onsets_mod, chroma_mod = (importlib.import_module(f"maua_tpu_torch.audio.{m}") for m in ("hpss", "onsets", "chroma"))
    y = args.audio
    perc, out = {}, {}
    perc["percussive"], out["percussive"] = timed(lambda: hpss.percussive(y, margin=8.0))
    _, out["madmom_onset_ensemble"] = timed(lambda: onsets_mod.madmom_onset_ensemble(perc["percussive"], sr=SR, fmax=150.0))
    _, out["onsets"] = timed(lambda: ar.onsets(y, SR, args.n_frames, fmax=150, smooth=5, clip=97, power=2))
    harm, out["harmonic"] = timed(lambda: hpss.harmonic(y, margin=16.0))
    _, out["pseudo_cqt"] = timed(lambda: chroma_mod.pseudo_cqt(harm, sr=SR))
    raw, out["chroma_cens"] = timed(lambda: chroma_mod.chroma_cens(harm, sr=SR))
    _, out["nn_filter_cosine"] = timed(lambda: chroma_mod.nn_filter_cosine(raw))
    _, out["chroma"] = timed(lambda: ar.chroma(y, SR, args.n_frames))
    draws, out["draw_256"] = timed(lambda: _draw(256, 256, 16, args.n_frames, y.device))
    _, out["gaussian_filter_sigma128_256"] = timed(lambda: ar.gaussian_filter(draws[1], 128))
    _, out["gaussian_filter_sigma5_256"] = timed(lambda: ar.gaussian_filter(draws[0], 5))
    return out


def phase_generate_main_path(tmp: str) -> dict:
    """generate() at full width: (a) the default plugin over a 180 s track,
    (b) generate() of a 12 s window with a translate bend, (c) the tauceti
    plugin at 1920 for 2 s; the forward kernel's launches counted in (b) and
    (c) and checked against the counts derived from the structure."""
    import maua_tpu_torch.audio as ar
    from maua_tpu_torch import examples
    from maua_tpu_torch.models.blocks import tf32
    from maua_tpu_torch.ops import fused_act
    from maua_tpu_torch.pipeline import defaults, generate, get_noise_range
    from maua_tpu_torch.pipeline.cli import load_plugin
    from maua_tpu_torch.reactive import translate_bend

    gen_mod = importlib.import_module("maua_tpu_torch.pipeline.generate")  # the package exports a function of that name
    ckpt = os.path.join(tmp, f"g{GEN_SIZE}.pt")
    wav = write_wav(os.path.join(tmp, "track.wav"), synth_track(TRACK_S, seed=8))
    per_batch = 2 * (int(math.log2(GEN_SIZE)) - 2) + 1  # StyledConv activations of one forward from W+
    results = {}

    # ---- (a) the default plugin over the whole track, twice: the first run
    # pays cuFFT's plans and cuDNN's set-up for the track's sizes ----
    audio = ar.load_audio(wav, cache=False)[0]
    ar.set_SMF(1.0)
    ar.set_device("cuda")
    sel = torch.from_numpy(0.5 * np.random.default_rng(9).standard_normal((12, 18, STYLE_DIM)).astype(np.float32)).cuda()
    for run in ("first", "repeat"):
        args = plugin_args(audio, "cuda")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with tf32(conv=False, matmul=False):
            _, init_s = timed(lambda: defaults.initialize(args))
            latents, latents_s = timed(lambda: defaults.get_latents(selection=sel, args=args))
            noise, noise_s = [], {}
            lo, hi, side = get_noise_range(GEN_SIZE, GEN_SIZE)
            for scale in range(lo, hi):
                size = 2 ** side(scale)
                n, s = timed(lambda: defaults.get_noise(height=size, width=size, scale=scale - lo, num_scales=hi - lo, args=args))
                noise.append(n)
                noise_s[f"{scale - lo}:{size}"] = s
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            stage_s = staging_seconds(latents, noise)
            breakdown = preprocess_breakdown(args) if run == "repeat" else None
        timeline_bytes = latents.numel() * 4 + sum(0 if n is None else n.numel() * 4 for n in noise)
        require(all(bool(torch.isfinite(x).all()) for x in [latents, *[n for n in noise if n is not None]]),
                "(a) finite timelines")
        results[f"a_{run}"] = dict(initialize_s=init_s, get_latents_s=latents_s, get_noise_s=sum(noise_s.values()),
                                   preprocess_s=init_s + latents_s + sum(noise_s.values()), timeline_bytes=timeline_bytes,
                                   peak_memory_gb=peak_gb, staging_round_trip_s=stage_s)
        emit(phase="generate_preprocess", run=run, track_seconds=TRACK_S, fps=30, n_frames=args.n_frames,
             **results[f"a_{run}"], get_noise_s_by_layer=noise_s, breakdown_s=breakdown)
        del args, latents, noise
    del sel
    torch.cuda.empty_cache()

    # ---- (b), (c): generate() end to end, the forward kernel's launches counted ----
    calls = {}

    def timed_render(*a, **kw):
        calls["render_start"] = time.perf_counter()
        calls["timelines"] = (kw["latents"], kw["noise"])
        out = real_render(*a, **kw)
        calls["render_s"] = time.perf_counter() - calls["render_start"]
        return out

    real_render = gen_mod.render
    CountingWriter = install_counting_writer()
    runs = {
        "b": dict(offset=60.0, duration=12.0, batch=8, truncation=0.75, out_size=GEN_SIZE,
                  get_bends=lambda args: [translate_bend(4, modulation=args.hi_onsets)]),
        "c": dict(offset=60.0, duration=2.0, batch=8,
                  **{**load_plugin(os.path.join(os.path.dirname(examples.__file__), "tauceti.py"))[0], "out_size": 1920}),
    }
    shapes = {}
    gen_mod.render = timed_render
    try:
        for label, kw in runs.items():
            n_frames = int(round(kw["duration"] * 30))
            batches = -(-n_frames // kw["batch"])
            # generate_latents maps 12 z (8 launches); mean_latent only when truncated (8); 17 per render batch
            expected = N_MLP + (N_MLP if kw.get("truncation", 1.0) != 1.0 else 0) + per_batch * batches
            CountingWriter.written = []
            torch.cuda.synchronize()
            fused_act.launches = fused_act.grad_launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                fwd, _ = record_launch_shapes(lambda: generate(ckpt, wav, fps=30, output_file=os.path.join(tmp, f"gen_{label}.mp4"),
                                                               device="cuda", **kw))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = fused_act.launches
            shapes[label] = fwd
            require(launches == expected, f"({label}) fused_bias_act launched {launches} times, expected {expected}")
            require(fused_act.grad_launches == 0, f"({label}) generate launched the gradient kernel")
            require(len(CountingWriter.written) == n_frames and min(CountingWriter.written) > 0,
                    f"({label}) {len(CountingWriter.written)} frames written")
            latents, noise = calls["timelines"]
            results[label] = dict(frames=n_frames, batch=kw["batch"], out_size=kw["out_size"], launches=launches,
                                  expected_launches=expected, wall_s=wall, frames_per_s=n_frames / wall,
                                  preprocess_s=calls["render_start"] - t0, render_s=calls["render_s"],
                                  render_fps=n_frames / calls["render_s"], staging_round_trip_s=staging_seconds(latents, noise),
                                  timeline_bytes=latents.numel() * 4 + sum(0 if n is None else n.numel() * 4 for n in noise),
                                  writer=CountingWriter.backend_used)
            emit(phase="generate_main_path", run=label, size=GEN_SIZE, style_dim=STYLE_DIM, n_mlp=N_MLP,
                 channel_multiplier=CHANNEL_MULTIPLIER, **results[label])
            calls.clear()
            torch.cuda.empty_cache()
    finally:
        gen_mod.render = real_render
    results["shapes"] = shapes
    return results


def phase_kernels_generate(shapes: dict) -> dict:
    """The forward kernel at every launch shape of generate() runs (b) and (c)
    that the render phase did not already hold: kernel vs plain, fp32."""
    from collections import Counter

    from maua_tpu_torch.ops.fused_act import fused_bias_act, fused_leaky_relu_plain

    seen = {s for s, _ in render_batch_shapes(8)} | {(8, 512), (16384, 512)}
    counts = Counter()
    for fwd in shapes.values():
        counts.update(fwd)
    rows = []
    for (shape, dtype, with_bias), n in sorted(counts.items()):
        if shape in seen:
            continue
        seen.add(shape)
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(shape, generator=g, device="cuda")
        b = torch.randn(shape[1] if len(shape) >= 3 else shape[-1], generator=g, device="cuda") if with_bias else None
        got, want = fused_bias_act(x, b), fused_leaky_relu_plain(x, b)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        moved = 2 * x.numel() * 4 + (0 if b is None else 4 * b.numel())
        rows.append(dict(shape=list(shape), launches=n, max_abs_err=(got - want).abs().max().item(),
                         ms=fast_ms(lambda: fused_bias_act(x, b), x.numel()),
                         plain_ms=fast_ms(lambda: fused_leaky_relu_plain(x, b), x.numel()),
                         bound_ms=moved / HBM_BYTES_PER_S * 1e3))
        del x, b, got, want
        torch.cuda.empty_cache()
    emit(phase="kernel_generate", kernel="fused_bias_act", dtype="float32", shapes=rows)
    return {"shapes": rows}


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
    phase_functions_on_card()
    with tempfile.TemporaryDirectory() as tmp:
        phase_card_vs_cpu(tmp)
        results = phase_main_path(tmp)
        phase_train_card_vs_cpu()
        train = phase_train_main_path(tmp)
        with contextlib.chdir(tmp):  # load_audio's and generate()'s workspace/
            phase_generate_card_vs_cpu(tmp)
            gen = phase_generate_main_path(tmp)
    per_step = phase_kernels_train(train["shapes"])
    phase_kernels_generate(gen["shapes"])

    emit(phase="kernel_render_batch_fp32", kernel="fused_bias_act", render_launches=results["fp32_exact"]["launches"],
         **{k: per_batch["float32"][k] for k in ("ms", "plain_ms", "bound_ms")})
    # the kernels line: this slice's main path, the fp32 exact training run;
    # times are sums over the launches of one fp32 step with R1 and the path
    # penalty (per-launch-shape lines above, `kernel_grad`, `kernel_train_step`)
    step_fp32 = per_step["fp32_exact"]
    launches = dict(zip(("fused_bias_act", "fused_bias_act_grad"), train["results"]["fp32_exact"]["launches"]))
    rows = []
    for name, replaces in (("fused_bias_act", "maua_tpu/ops/pallas_act.py:38"),
                           ("fused_bias_act_grad", "maua_tpu/ops/pallas_act.py:43")):
        t = step_fp32[name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "maua_tpu_torch/csrc/fused_bias_act.cu",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": t["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the maua_tpu_torch port on one CUDA card and check it.

    python3 chip_smoke.py        # from the repo root, on a machine with a CUDA card

Phases, each printing JSON lines:
  1. card and build: nvidia-smi's name and power limit, then nvcc builds every
     kernel of maua_tpu_torch/csrc (seconds, registers);
  2. kernels against their plain PyTorch versions at the main paths' shapes,
     fp32 and bf16, with CUDA-event times (median of 25), the memory bound and
     the largest error: the fused bias + leaky-ReLU forward at the render
     shapes (`kernel`, `kernel_render_batch`; both kernels at the training
     shapes after the runs, `kernel_train_shapes`), plus first-order (dx,
     db) and the grad of a grad-norm through the two autograd Functions on
     the card against plain autograd; the upfirdn2d kernel against its plain
     form at render's sites (batch 8, 1024^2) and a 256^2 training step's
     (forward and backward geometries of G at batch 12 and of D's fused
     pass at 24), and in fp32 at a 1024^2 StyleGAN1 synthesis' eight
     [1, 2, 1] blurs (batch 8), beside its memory bound and F.conv2d's depthwise conv
     (`library_ms`, a yardstick the port does not call);
  3. generator, card against CPU: a full-width 256^2 checkpoint made from a
     numpy seed, same W+ latents and noise, exact fp32, max abs <= 1e-3;
  4. the render path at full width: a random-weight checkpoint of the
     rosinality FFHQ-1024 configuration -> load_generator -> mean_latent ->
     render() of 48 frames at batch 8 into an mp4, with tensor truncation and
     an explicit noise timeline up to 256 wide. The launch counters are set to
     0 just before and read just after; the forward kernel must have run
     exactly 8 (mapping) + 17 x 6 (render batches) times, upfirdn2d 16 x 6.
     Then frames/s for fp32 exact, fp32 fast and bf16, and the top CUDA ops
     of one 1024^2 batch from torch.profiler;
  5. training, card against CPU (`train_card_vs_cpu`): a narrow model (32^2,
     channel_max 64, batch 4), each phase of a step with R1 and the path
     penalty due, from the same weights and the same explicit draws, exact
     fp32 on both; and R1, G and the path penalty at batch 8 with
     reg_chunks 2 and remat_synth on;
  6. the training path at full width (`train_main_path`): synthetic raw
     shards at 256^2 -> the train CLI's parser -> train_loop (channel
     multiplier 2, channel_max 512, constant input, batch 12, --no-augment,
     lookahead on) for 8 steps in fp32 exact and again in bf16. The counters
     are set to 0 just before each run and read just after; every step's
     launches of the three kernels must equal the counts derived from the
     model's structure (expected_launches, expected_fir_launches). s/step
     by kind of step, imgs/s, per-phase CUDA-event times, peak memory; the checkpoint's g_ema goes through load_generator and
     render(); R1's gradients with upfirdn2d's autograd Function against
     autograd of its depthwise conv (`r1_upfirdn2d_autograd`, fp32);
     torch.profiler over one step with R1 and the path penalty and over one
     plain step;
  7. ADA, card against CPU (`augment_card_vs_cpu`): the conv, matmul,
     1x-grid matmul and fft warps and the colour matrix at the fused D batch
     of the main path ([24, 3, 256, 256] fp32, one draw at p = 0.5), values
     and input gradients within 1e-4; the fft warp's dftmm shear against its
     fft shear on the card in fp32 and bf16;
  8. ADA times (`augment_times`): each warp forward and forward + backward
     at [24, 3, 256, 256] in fp32 and bf16, the fft warp with either shear,
     and the whole augment at 1024^2, batch 8;
  9. ADA training, card against CPU (`train_ada_card_vs_cpu`): one D, ADA
     and G update at 32^2 with the fft warp at p = 0.5, alone, with bCR and
     with the contrastive regularizer (momentum 0.99, queue 16);
 10. the ADA training path at full width (`train_ada_main_path`): PNGs ->
     the port's prepare_data -> raw shards -> the train CLI's default
     configuration (ADA on, the fft warp) at 256^2, batch 12: (a) fp32 and
     bf16 at p = 0.5, 8 steps each, launches per step checked against the
     structure; (b) bf16 with adaptive p, 24 steps, p against ada_adjust_p
     recomputed on the host from the logged sign sums; (c) bf16 with bCR,
     contrastive and MoCo, 4 steps; profiles of an R1 + path step with ADA
     and the fft warp's share (`ada_warp_share`);
 11. generate(), card against CPU (`generate_card_vs_cpu`): on a 20 s track
     made from a numpy seed, the onset function, the default plugin's onset
     envelopes, chroma and latents (latent file set), every bend transform,
     and one generate() at 256^2 full width with numpy noise and truncation 1;
 12. generate() at full width (`generate_preprocess`, `generate_main_path`):
     (a) the default plugin over a 180 s track at 30 fps, seconds per
     function, timeline bytes, peak memory and the staging round trip;
     (b) generate() of a 12 s window of the FFHQ-1024 configuration at batch
     8, truncation 0.75, a translate bend on layer 4 driven by the high
     onsets; (c) the tauceti example plugin at out_size 1920 for 2 s. The
     counters are set to 0 just before (b) and (c) and read just after: 8
     (generate_latents) + 8 if truncated (mean_latent) + 17 per batch
     forward launches, 16 upfirdn2d launches per batch. Then the forward
     kernel against its plain version at the launch shapes of (b) and (c)
     not held before (`kernel_generate`).
 13. the inference tools, StyleGAN1, TF pickles and evaluation, card against
     CPU at 256^2 in exact fp32 (`tools_card_vs_cpu`): LPIPS vgg and alex,
     Inception in both variants, a full-width StyleGAN1, the projector's
     first step (loss, latent and noise gradients) with LPIPS-VGG, and a TF
     Gs pickle's conversion (equal state dicts) and images;
 14. the same at full width through their entry points (`tools_main_path`),
     each with its kernel launches (upfirdn2d's too) set to 0 just before,
     read just after and checked against the structure: (a) sample() of 64
     images at 1024^2; (b) project() of a 1024^2 target, 100 steps,
     LPIPS-VGG on 256^2 resizes (17 forward + 17 gradient launches, 32
     upfirdn2d launches per step); (c) a 10 s
     interpolation_video() with segmented noise; (d) generate_and_select()
     of 24 images; (e) generate(stylegan1=True) over 4 s with the FFHQ
     StyleGAN1 (8 upfirdn2d launches a synthesis), and load_tf_generator()
     of a full-width Gs pickle; (f) the
     eval CLI's inception (512 images at 256^2) and fid (1024 samples) in
     exact and fast, ppl (256 pairs, LPIPS-VGG) in exact, and ppl refusing
     fast; (g) the default train CLI
     with --eval_every and SWD. Then both kernels against their plain
     versions at the launch shapes of (a), (b) and (f) not held before
     (`kernel_tools`).
 15. the VAE, card against CPU (`vae_card_vs_cpu`): LogCoshVAE at the
     reference's widths (hidden 32-512, latent 512), 64^2, batch 8, training
     mode: forward, running statistics and one step's gradients;
 16. the VAE path (`vae_main_path`): 512 synthetic 64^2 images -> vae_cli
     --size 64 --batch_size 64 for 51 steps -> prepare_vae_codes over the
     shards with the trained weights; 10 + 10 launches per train step and 5
     per encoded batch, counted; images/s, s/step, the loss, codes/s, peak
     memory; then both kernels against their plain versions at every VAE
     launch shape in fp32 and bf16 (`kernel_vae`, `kernel_vae_step`);
 17. telemetry (`telemetry`): the default train CLI at 256^2 for 8 steps
     without and with --log_spec_norm --monitor --profile, s/step of each,
     the trace, gpumon.jsonl and the sigmas; the monitor thread and the
     memory helpers on the card;
 18. data parallel on one card (`parallel_on_card`): the train CLI at world
     size 1 over NCCL (--coordinator) against no coordinator at 256^2,
     batch 12: the default, --reg_chunks 3, and the contrastive regularizer
     with MoCo and a queue; one bf16 R1 + path step of phase 23's
     configuration under a coordinator (reg_chunks 3 resolved, launches
     counted); render(mesh=[cuda:0]) against render() at 1024^2;
 19. generate() with the temper and rewrite_demo plugins at 1024^2 for 2 s
     (`plugins`), the forward kernel's and upfirdn2d's launches counted;
 20. the lucidrains family, card against CPU (`lucidrains_card_vs_cpu`): a
     narrow model (32^2, capacity 4, attention and fq at layer 1) with the
     same weights and draws: G and D forwards, then three steps (the
     gradient and path penalties, the EMA, the reset): metrics, gradients,
     the weights after DiffGrad and the EMA copies;
 21. the lucidrains trainer at the JAX config's full width
     (`lucidrains_main_path`): LucidrainsTrainer at 128^2, latent 512, style
     depth 8, capacity 16, batch 4, 33 steps with the defaults and with
     attention and fq at layer 1 (no kernel launch, counted); s/step by kind,
     images/s, peak memory, a save / load round trip, generate(n=8);
 22. tensor-parallel synthesis on the card (`tp_on_card`): the FFHQ-1024
     generator under shard_generator_params on a (1, 1) mesh over NCCL at
     world size 1, frames against the unsharded generator's at batch 8, the
     forward kernel's 8 + 17 and upfirdn2d's 16 launches counted, time with
     and without the sharding;
 23. the JAX package's flagship training configuration at full width
     (`train_1024_main_path`): synthetic 1024^2 raw shards -> the train
     CLI's default at --size 1024 --batch_size 12 (ADA with the fft and
     1x-grid warps, lookahead; the automatic rule resolves reg_chunks 3 and
     remat_synth on), 4 steps in bf16 and 2 in fp32 exact, every step's
     launches of the three kernels checked against the structure (remat's
     recomputed synthesis included), and the run's conv double backwards
     (`ops.conv.second_order`: D's convs per R1 chunk, G's modulated convs
     per path chunk); s/step by kind, images/s, peak memory,
     device ms per phase of the R1 + path step; one bf16 R1 + path step
     with --reg_chunks 1 --remat_synth 0 for its peak memory; then both
     kernels against their plain versions at every launch shape of an
     R1 + path step in fp32 and bf16 (`kernel_train_shapes`,
     `kernel_train_step` with size 1024).
The line before the last lists the kernels (`kernels`): the two bias-act
kernels with their launches in the VAE trainer's run of phase 16 and times
summed over one fp32 VAE step, beside them `train_1024`, the launches of
phase 23's runs and the times summed over one of its R1 + path steps in
each precision, and `ada_run_launches`; then upfirdn2d, with its launches
in phase 4's fp32 render run and times summed over one render batch's 16
sites, a 256^2 step's sites, a StyleGAN1 batch's 8 blur sites, and its
launches in the ADA and flagship runs
(`kernels_train` keeps the fp32 ADA run's numbers of earlier slices). The
last line is {"ok": true, "device": {...}}. Any failure exits non-zero
before it; without a CUDA card, or without the package beside this file,
the script fails at once.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import math
import os
import shutil
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


def graph_ms(fn, reps: int = 10, runs: int = 25, sleep_cycles: int = 1_000_000) -> float:
    """Median device time of one fn() in ms: `reps` back-to-back calls are
    captured in a CUDA graph and replayed, so no host launch latency sits
    between them (eager timing of a small kernel measures the host instead).
    Before each replay the card sleeps `sleep_cycles` clock cycles (about
    0.5 ms), so that the host has enqueued the start event, the replay and
    the end event before the card reaches them: on a busy host the submission
    of a replay of a few microseconds of work takes longer than the work, and
    the events would time the host. sleep_cycles=0 leaves the sleep out and
    times the replays back to back (cuda_ms)."""
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
    if not sleep_cycles:
        return cuda_ms(graph.replay, runs) / reps
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times) / reps


# ---------------------------------------------------------------- phase 2
def bias_act_case(shape, dtype, with_bias, seed=0, eager=True):
    """Kernel vs plain on one input.

    Returns a dict: max_abs_err vs plain, max_abs_err_fp32_once vs the fp32
    result rounded once, kernel_ms / plain_ms (device time, graph replay),
    eager_ms / plain_eager_ms (one eager call, host launch included; left out
    with eager=False, which also replays the largest tensors fewer times,
    as fast_ms does), bound_ms. fp32: rtol = atol = 1e-6. bf16: two
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
    del want, once
    timer = graph_ms if eager else (lambda fn: fast_ms(fn, x.numel()))
    out = dict(
        max_abs_err=err,
        max_abs_err_fp32_once=err_once,
        kernel_ms=timer(lambda: fused_bias_act(x, b)),
        plain_ms=timer(lambda: fused_leaky_relu_plain(x, b)),
        bound_ms=moved / HBM_BYTES_PER_S * 1e3,
    )
    if eager:
        out.update(eager_ms=cuda_ms(lambda: fused_bias_act(x, b)),
                   plain_eager_ms=cuda_ms(lambda: fused_leaky_relu_plain(x, b)))
    return out


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


def fir_sites_render(batch: int = 8, size: int = 1024) -> list:
    """(site, input shape, taps gain, up, down, pad) of one synthesis forward:
    the blur after each transposed conv (a 2r + 1 plane to r) and each
    ToRGB's Upsample of the 3-channel skip, r = 8 .. size."""
    from maua_tpu_torch.models import channel_map

    ch = channel_map(CHANNEL_MULTIPLIER)
    sites, res = [], 8
    while res <= size:
        sites.append((f"blur_{res}", (batch, ch[res], res + 1, res + 1), 4.0, 1, 1, (1, 1, 1, 1)))
        sites.append((f"upsample_{res}", (batch, 3, res // 2, res // 2), 4.0, 2, 1, (2, 1, 2, 1)))
        res *= 2
    return sites


def fir_sites_train(batch: int = 12, size: int = 256) -> list:
    """The sites of a training step at `size`: G's (batch) forward and
    backward geometries, and D's (the fused pass, 2 x batch): each ResBlock's
    blur before the strided conv (pad 2, 2), its skip's (1, 1), and their
    backward geometries."""
    from maua_tpu_torch.models import channel_map

    ch = channel_map(CHANNEL_MULTIPLIER)
    sites = []
    for name, shape, gain, up, down, pad in fir_sites_render(batch, size):
        sites.append((name, shape, gain, up, down, pad))
        n, c, h, w = shape
        if up == 1:
            sites.append((name + "_back", (n, c, h - 1, w - 1), gain, 1, 1, (2, 2, 2, 2)))
        else:
            sites.append((name + "_back", (n, c, 2 * h, 2 * w), gain, 1, 2, (1, 1, 1, 1)))
    res = size
    while res >= 8:
        shape = (2 * batch, ch[res], res, res)
        sites.append((f"d_blur_{res}", shape, 1.0, 1, 1, (2, 2, 2, 2)))
        sites.append((f"d_blur_{res}_back", (2 * batch, ch[res], res + 1, res + 1), 1.0, 1, 1, (1, 1, 1, 1)))
        sites.append((f"d_skip_{res}", shape, 1.0, 1, 1, (1, 1, 1, 1)))
        sites.append((f"d_skip_{res}_back", (2 * batch, ch[res], res - 1, res - 1), 1.0, 1, 1, (2, 2, 2, 2)))
        res //= 2
    return sites


def fir_sites_sg1(batch: int = 8, size: int = 1024) -> list:
    """The sites of one StyleGAN1 synthesis forward (taps [1, 2, 1]): the blur
    after each block's up-conv, an r x r plane of nf channels to r x r with
    pad 1, r = 8 .. size (512 channels to 32^2, then 256 .. 16)."""
    from maua_tpu_torch.models.stylegan1 import nf

    sites, res = [], 8
    while res <= size:
        sites.append((f"sg1_blur_{res}", (batch, nf(int(math.log2(res)) - 1), res, res), 1.0, 1, 1, (1, 1, 1, 1)))
        res *= 2
    return sites


def fir_case(shape, gain, up, down, pad, dtype, taps=(1, 3, 3, 1), seed=0) -> dict:
    """The upfirdn2d kernel against its plain form on one input: the largest
    error (fp32: rtol = atol = 1e-5; bf16: two ulps), kernel_ms, plain_ms
    (the padded copy and the depthwise conv), library_ms (F.conv2d's
    depthwise conv alone, on an input already stuffed and padded: the
    yardstick the port no longer calls), bound_ms (input read once and
    output written once at 3.35 TB/s), all by graph replay."""
    import torch.nn.functional as F

    from maua_tpu_torch.ops.upfirdn2d import setup_filter, upfirdn2d_kernel, upfirdn2d_plain

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda").to(dtype)
    k = setup_filter(list(taps), gain=gain).cuda()
    ups, downs = (up, up), (down, down)
    with tf32_off():
        got = upfirdn2d_kernel(x, k, ups, downs, pad)
        want = upfirdn2d_plain(x, k, ups, downs, pad)
        torch.cuda.synchronize()
        tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=1.6e-2, atol=1e-2)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        err = (got.float() - want.float()).abs().max().item()
        n, c, h, w = shape
        xs = x
        if up > 1:
            xs = F.pad(x.reshape(n, c, h, 1, w, 1), [0, up - 1, 0, 0, 0, up - 1]).reshape(n, c, h * up, w * up)
        xs = F.pad(xs, [pad[0], pad[1], pad[2], pad[3]])
        kd = torch.flip(k, (0, 1)).to(dtype)[None, None].expand(c, 1, *k.shape).contiguous()
        moved = (x.numel() + got.numel()) * x.element_size()
        out = dict(
            out_shape=list(got.shape),
            max_abs_err=err,
            kernel_ms=graph_ms(lambda: upfirdn2d_kernel(x, k, ups, downs, pad)),
            plain_ms=graph_ms(lambda: upfirdn2d_plain(x, k, ups, downs, pad)),
            library_ms=graph_ms(lambda: F.conv2d(xs, kd, stride=down, groups=c)),
            bound_ms=moved / HBM_BYTES_PER_S * 1e3,
        )
    out["bound_share"] = out["bound_ms"] / out["kernel_ms"]
    return out


def phase_kernels_upfirdn2d() -> dict:
    """The upfirdn2d kernel at render's sites (batch 8, 1024^2), at a 256^2
    training step's (batch 12, D's fused pass 24), fp32 and bf16, and at a
    1024^2 StyleGAN1 synthesis' 3-tap blurs (batch 8, fp32, the precision
    it renders in): one row a site and the sums."""
    totals = {}
    fir4, fir3 = (1, 3, 3, 1), (1, 2, 1)
    fp32, both = (torch.float32,), (torch.float32, torch.bfloat16)
    for label, sites, taps, dtypes in (("render_1024_b8", fir_sites_render(), fir4, both),
                                       ("train_256_b12", fir_sites_train(), fir4, both),
                                       ("sg1_1024_b8", fir_sites_sg1(), fir3, fp32)):
        for dtype in dtypes:
            name = str(dtype).split(".")[1]
            tot = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, n_sites=0)
            for site, shape, gain, up, down, pad in sites:
                case = fir_case(shape, gain, up, down, pad, dtype, taps)
                emit(phase="kernel", kernel="upfirdn2d", sites=label, site=site, shape=list(shape), up=up, down=down,
                     pad=list(pad), taps=list(taps), dtype=name, bound_by="bytes", **case)
                tot["max_abs_err"] = max(tot["max_abs_err"], case["max_abs_err"])
                for k, v in (("ms", "kernel_ms"), ("plain_ms", "plain_ms"), ("library_ms", "library_ms"),
                             ("bound_ms", "bound_ms")):
                    tot[k] += case[v]
                tot["n_sites"] += 1
            tot["bound_share"] = tot["bound_ms"] / tot["ms"]
            emit(phase="kernel_sites", kernel="upfirdn2d", sites=label, dtype=name, **tot)
            totals[f"{label}_{name}"] = tot
    return totals


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

    fir = fir_module()
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
        fused_act.launches = fused_act.grad_launches = fir.launches = 0
        t0 = time.perf_counter()
        tl = gen.mean_latent(torch.Generator(device="cuda").manual_seed(5))
        render(gen, None, latents, noise, out, batch_size=batch, fps=24, truncation=trunc, truncation_latent=tl)
        render_s = time.perf_counter() - t0
        launches, fir_launches = fused_act.launches, fir.launches

        expected = N_MLP + 17 * (n_frames // batch)
        fir_expected = fir_per_pass(1024) * (n_frames // batch)  # mean_latent runs no synthesis
        require(len(CountingWriter.written) == n_frames, f"{label}: {len(CountingWriter.written)} frames written")
        require(min(CountingWriter.written) > 0, f"{label}: a written frame is constant")
        require(launches == expected, f"{label}: fused_bias_act launched {launches} times, expected {expected}")
        require(fused_act.grad_launches == 0, f"{label}: render launched the gradient kernel")
        require(fir_launches == fir_expected, f"{label}: upfirdn2d launched {fir_launches} times, expected {fir_expected}")
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
        results[label] = dict(launches=launches, fir_launches=fir_launches, render_fps=n_frames / render_s, synth_fps=fps)
        emit(phase="main_path", config=label, size=1024, style_dim=STYLE_DIM, n_mlp=N_MLP,
             channel_multiplier=CHANNEL_MULTIPLIER, frames=n_frames, batch=batch, launches=launches,
             expected_launches=expected, upfirdn2d_launches=fir_launches, load_seconds=load_s, render_seconds=render_s,
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

    # ada_warp_method: what the CLI's `--ada_warp auto` resolves to on the card
    kw = dict(size=TRAIN_SIZE, batch_size=TRAIN_BATCH, channel_multiplier=CHANNEL_MULTIPLIER, channel_max=512,
              constant_input=True, augment=False, lookahead=True, bf16=bf16, ada_warp_method="fft")
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
    3 x n_layers + 2 x n_mlp. ADA's warp and colour matrix launch neither
    kernel; the D phase applies D once to the interleaved batch, or twice
    (fakes and reals apart) with bCR or the contrastive regularizer. bCR
    adds two D passes on the raw images and their backward; the
    contrastive regularizer four passes through D's hidden layer, H = Dn - 2
    activations (queries from the raw images, with a backward; keys from
    the augmented ones, with a backward only without the momentum key
    encoder). The projection head uses a plain ReLU. With `remat_synth` the
    G phase's backward runs the synthesis from W+ once more (the checkpointed
    region, without the mapping network): n_layers more forward launches per
    microbatch. `reg_chunks` k runs R1's D and the path penalty's G k times
    on k-times smaller chunks."""
    n_mlp = 8
    log_size = int(math.log2(cfg.size))
    latent_in = 0 if cfg.constant_input else 2
    n_layers = 2 * (log_size - 2) + 1 + latent_in
    synth = 2 * n_mlp + n_layers
    disc = 1 + 2 * (log_size - 2) + 1 + 1
    hidden = disc - 2
    a, k = cfg.num_accumulate, max(1, cfg.reg_chunks)
    d_passes = 1 if cfg.batch_size % 4 == 0 and cfg.bcr_weight == 0 and cfg.contrastive_weight == 0 else 2
    d_passes += 2 if cfg.bcr_weight > 0 else 0
    fwd = a * (synth + d_passes * disc) + a * (synth + disc)  # D phase (G without grad, D) and G phase (G, D)
    fwd += a * n_layers if cfg.remat_synth else 0  # the G phase's synthesis again, in its backward
    grad = a * d_passes * disc + a * (disc + synth)
    if cfg.contrastive_weight > 0:
        fwd += a * 4 * hidden
        grad += a * (2 if cfg.contrastive_momentum > 0 else 4) * hidden
    if cfg.r1 > 0 and step % cfg.d_reg_every == 0:
        fwd, grad = fwd + a * k * disc, grad + a * k * 3 * disc
    if cfg.path_regularize > 0 and step % cfg.g_reg_every == 0:
        fwd, grad = fwd + a * k * synth, grad + a * k * (3 * n_layers + 2 * n_mlp)
    return fwd, grad


def expected_second_order(cfg, step: int) -> int:
    """`ops.conv.second_order` of train step `step`: each conv's double
    backward runs once a regularized chunk, D's Dc = from_rgb + 3 per ResBlock
    + final_conv convs for R1, G's n_layers StyledConvs and log2(size) - 1
    ToRGBs for the path penalty; num_accumulate x reg_chunks chunks each."""
    log_size = int(math.log2(cfg.size))
    a, k = cfg.num_accumulate, max(1, cfg.reg_chunks)
    n = 0
    if cfg.r1 > 0 and step % cfg.d_reg_every == 0:
        n += a * k * (1 + 3 * (log_size - 2) + 1)
    if cfg.path_regularize > 0 and step % cfg.g_reg_every == 0:
        n += a * k * ((2 * (log_size - 2) + 1) + (log_size - 1))
    return n


def fir_module():
    """ops/upfirdn2d.py, whose `launches` counts the kernel's launches (the
    package exports a function of that name)."""
    return importlib.import_module("maua_tpu_torch.ops.upfirdn2d")


def fir_per_pass(size: int) -> int:
    """upfirdn2d calls of one synthesis forward at size^2 (the blur after each
    transposed conv and each ToRGB's Upsample of the skip, 8^2 .. size^2),
    and as many in one D forward (each ResBlock's blur before its strided
    conv and its skip's)."""
    return 2 * (int(math.log2(size)) - 2)


def sg1_fir_per_pass(size: int) -> int:
    """upfirdn2d calls of one StyleGAN1 synthesis at size^2: the [1, 2, 1]
    blur after each block's up-conv, 8^2 .. size^2 (8 at 1024^2)."""
    return int(math.log2(size)) - 2


def expected_fir_launches(cfg, step: int) -> int:
    """upfirdn2d kernel launches of train step `step`, from the model's
    structure: a call launches once forward and once in each backward that
    passes it. With F = fir_per_pass(size): the D phase runs G without grad
    (F) and D forward and backward on each of its passes (2F each); the G
    phase G and D forward and backward (4F); R1 runs D forward, backward and,
    in its double backward, the backward's backward and the forward node
    again (4F); the path penalty stops at W+: G forward, backward and the
    backward's backward (3F). bCR, the contrastive regularizer, remat_synth,
    num_accumulate and reg_chunks add as in expected_launches (the hidden
    layer holds all of D's calls). ADA's fft and matmul warps launch none;
    its conv warp is not counted here."""
    require(not cfg.augment or cfg.ada_warp_method in ("fft", "matmul"),
            f"expected_fir_launches counts no conv warp (ada_warp_method {cfg.ada_warp_method})")
    f = fir_per_pass(cfg.size)
    a, k = cfg.num_accumulate, max(1, cfg.reg_chunks)
    d_passes = 1 if cfg.batch_size % 4 == 0 and cfg.bcr_weight == 0 and cfg.contrastive_weight == 0 else 2
    d_passes += 2 if cfg.bcr_weight > 0 else 0
    n = a * (f + 2 * d_passes * f) + a * 4 * f + (a * f if cfg.remat_synth else 0)
    if cfg.contrastive_weight > 0:
        n += a * (4 + (2 if cfg.contrastive_momentum > 0 else 4)) * f
    if cfg.r1 > 0 and step % cfg.d_reg_every == 0:
        n += a * k * 4 * f
    if cfg.path_regularize > 0 and step % cfg.g_reg_every == 0:
        n += a * k * 3 * f
    return n


def launches_per_kind(cfg, kinds) -> dict:
    """{kind: {forward, gradient, upfirdn2d}} for each (kind, step)."""
    return {k: dict(zip(("forward", "gradient"), expected_launches(cfg, i)), upfirdn2d=expected_fir_launches(cfg, i))
            for k, i in kinds}


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


def to(obj, device):
    """A draw (tensors, lists, named tuples, dataclasses of them) on `device`."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to(o, device) for o in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(to(o, device) for o in obj)
    return type(obj)(**{k: to(v, device) for k, v in vars(obj).items()})


def phase_train_card_vs_cpu():
    """Each phase of a step with R1 and the path penalty due, on the card
    (exact fp32) and on the CPU, from the same weights (init_train_state draws
    them on the CPU from the seed) and the same draws (made on the CPU and
    copied). Tolerance: losses rtol 1e-4; each gradient tensor max abs <=
    1e-3 x its max abs + 1e-6. Both sides are fp32 with TF32 off; they differ
    in the order of the convolutions' sums (cuDNN against oneDNN), which the
    double backward of R1 and the path penalty amplifies. A second case at
    batch 8 with reg_chunks 2 and remat_synth on runs R1 in two strided
    chunks of 4, the G phase through the checkpointed synthesis and the path
    penalty in two chunks, held to the same tolerances, with G's per-layer
    noise weights judged as one vector as phase 9 judges them
    (`grad_groups`); on the card its G phase also against the same phase
    without remat (the same arithmetic, recomputed, in another module
    instance whose convs cuDNN may run with other algorithms, as phase 6
    holds a loaded g_ema: loss rtol 1e-5, gradients within 1e-4 of each
    tensor's largest value, the noise weights as one vector)."""
    from maua_tpu_torch.train import draw_step, init_train_state, make_train_config, make_train_phases

    cases = {"base": (dict(batch_size=4), ("d", "r1", "g", "path")),
             "reg_chunks_2_remat": (dict(batch_size=8, reg_chunks=2, remat_synth=True), ("r1", "g", "path"))}
    for case, (over, names) in cases.items():
        cfg = make_train_config(size=32, channel_max=64, augment=False, constant_input=True, **over)
        draws = draw_step(cfg, 0, torch.Generator().manual_seed(3), "cpu")
        real = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (1, cfg.batch_size, 3, 32, 32)).astype(np.float32))

        out = {}
        for name in names:
            res = {}
            for dev in ("cpu", "cuda"):
                st = init_train_state(cfg, seed=1, device=dev)
                ph = make_train_phases(cfg)
                arg = {"d": (to(real, dev), to(draws.d, dev)), "r1": (to(real, dev),), "g": (to(draws.g, dev),),
                       "path": (to(draws.path, dev),)}[name]
                aux, grads = ph[name](st, *arg)
                loss = aux["d_loss"] if name == "d" else aux
                net = st.d if name in ("d", "r1") else st.g
                res[dev] = (float(loss), [g.detach().cpu() for g in grads])
            (l_cpu, g_cpu), (l_card, g_card) = res["cpu"], res["cuda"]
            tensors = [n for n, _ in net.named_parameters()]
            rel = {n: ((a - b).abs().max() / (b.abs().max() + 1e-12)).item() for n, a, b in zip(tensors, g_card, g_cpu)}
            max_abs = max((a - b).abs().max().item() for a, b in zip(g_card, g_cpu))
            out[name] = dict(loss_cpu=l_cpu, loss_card=l_card, grad_max_abs_err=max_abs, grad_max_rel_err=max(rel.values()),
                             worst_single_tensor=max(rel.items(), key=lambda kv: kv[1]))
            require(abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu) + 1e-7, f"{case} {name} loss: card {l_card} vs CPU {l_cpu}")
            require(all(bool(torch.isfinite(a).all()) for a in g_card), f"{case} {name}: card gradients are finite")
            groups = (dict(zip(tensors, zip(g_card, g_cpu))) if case == "base"
                      else grad_groups(tensors, g_card, g_cpu))
            for group, (a, b) in groups.items():
                err, scale = (a - b).abs().max().item(), b.abs().max().item()
                require(err <= 1e-3 * scale + 1e-6,
                        f"{case} {name}: card vs CPU gradient {group}: max abs err {err} against max abs {scale}")
            out[name]["grad_max_rel_err_as_judged"] = max(((a - b).abs().max() / (b.abs().max() + 1e-12)).item()
                                                          for a, b in groups.values())
        if cfg.remat_synth:
            st = init_train_state(cfg, seed=1, device="cuda")
            plain_cfg = cfg._replace(remat_synth=False)
            st_plain = init_train_state(plain_cfg, seed=1, device="cuda")
            remat = make_train_phases(cfg)["g"](st, to(draws.g, "cuda"))
            plain = make_train_phases(plain_cfg)["g"](st_plain, to(draws.g, "cuda"))
            remat_rel = max(((a - b).abs().max() / (b.abs().max() + 1e-12)).item()
                            for a, b in grad_groups([n for n, _ in st.g.named_parameters()], remat[1], plain[1]).values())
            require(abs(float(remat[0]) - float(plain[0])) <= 1e-5 * abs(float(plain[0])) and remat_rel <= 1e-4,
                    f"{case}: G phase with remat against without on the card: loss {float(remat[0])} vs "
                    f"{float(plain[0])}, gradients {remat_rel} of the largest value")
            out["g_remat_vs_plain_on_card_grad_max_rel_err"] = remat_rel
        emit(phase="train_card_vs_cpu", case=case, size=32, channel_max=64, batch=cfg.batch_size,
             reg_chunks=cfg.reg_chunks, remat_synth=cfg.remat_synth, precision="exact fp32",
             tolerance="loss rtol 1e-4; grad max abs <= 1e-3 x max abs + 1e-6" + ("" if case == "base" else
                                                                                   " (G's noise weights as one vector)"),
             phases=out)


def phase_train_main_path(tmp: str) -> dict:
    from maua_tpu_torch.data.synthetic import write_synth_shards
    from maua_tpu_torch.io import load_generator
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
        r = counted_train_run(argv(run, TRAIN_STEPS), cfg, TRAIN_STEPS, label)
        state, lines, launches, wall, peak_gb, s_step = (r[k] for k in ("state", "lines", "launches", "wall_s", "peak_gb",
                                                                       "s_step"))
        require(set(s_step) == {"r1_path", "path", "plain"}, f"{label}: step kinds {sorted(s_step)}")
        cycle = (s_step["r1_path"] + 3 * s_step["path"] + 12 * s_step["plain"]) / 16  # d_reg_every 16, g_reg_every 4
        per_kind = launches_per_kind(cfg, (("r1_path", 0), ("path", 4), ("plain", 1)))

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
             channel_max=512, steps=TRAIN_STEPS, launches=dict(zip(("forward", "gradient"), launches),
                                                               upfirdn2d=r["fir_launches"]),
             launches_per_step_kind=per_kind, s_per_step=s_step, imgs_per_s={k: TRAIN_BATCH / v for k, v in s_step.items()},
             imgs_per_s_16_step_cycle=TRAIN_BATCH / cycle, run_wall_s=wall, peak_memory_gb=peak_gb,
             phase_device_ms=phase_ms, losses_last={k: lines[-1][k] for k in ("Generator", "Discriminator")},
             checkpoint=os.path.basename(ckpt), loaded_g_ema_max_abs_err=g_ema_err)
        del state, gen, phases, step_fn
        torch.cuda.empty_cache()
    return {"results": results, "shapes": shapes}


def r1_with_autograd_upfirdn2d(state, real) -> None:
    """R1's D gradients at full width, once through upfirdn2d's autograd
    Function (the kernel) and once with autograd differentiating the plain
    form's depthwise conv directly (the form the Function replaced, whose double backward computes
    the FIR filter's gradient one channel at a time): device time of each and
    the largest difference of the gradients, relative to the tensor's max
    abs (limit 1e-4: the same sums in another order)."""
    import importlib

    import maua_tpu_torch.models.blocks as blocks
    from maua_tpu_torch.train.losses import d_r1_penalty

    fir = importlib.import_module("maua_tpu_torch.ops.upfirdn2d")  # the package exports a function of that name

    def by_autograd(x, kernel, up=1, down=1, pad=(0, 0)):
        return fir.upfirdn2d_plain(x, kernel.detach(), fir._as_pair(up), fir._as_pair(down), fir._as_pad(pad))

    params = list(state.d.parameters())

    def r1_grads():
        with tf32_off():
            grads = torch.autograd.grad(d_r1_penalty(state.d, real), params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]

    want = r1_grads()
    function_ms = cuda_ms(r1_grads, runs=3, warmup=0)
    blocks.upfirdn2d = by_autograd
    try:  # one timed run (about 10 s): it also gives the gradients held against the Function's
        out = []
        autograd_ms = cuda_ms(lambda: out.append(r1_grads()), runs=1, warmup=0)
        got = out[0]
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


def profile_train_step(step_fn, state, u8, cfg, gen_draws, label: str, step: int, size: int = TRAIN_SIZE) -> dict:
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
    # cuFFT's own kernels are the ADA fft warp's shears; cuDNN's FFT convolution
    # (fft2d_* kernels and a complex GEMM) is a conv algorithm it picks in fp32
    cufft_ms = sum(us for us, key, _ in rows if "regular_fft" in key or "vector_fft" in key) / 1e3
    fft_conv_ms = sum(us for us, key, _ in rows if "fft2d_" in key or "_cf32cf32_" in key) / 1e3
    out = dict(kernel_ms_total=total_ms, unprofiled_step_ms=wall_ms, device_busy_share=total_ms / wall_ms,
               kernels=len(rows), fused_kernels_ms=ours, cufft_kernels_ms=cufft_ms, cudnn_fft_conv_ms=fft_conv_ms,
               top=[dict(kernel=k, device_ms=us / 1e3, share=us / 1e3 / total_ms, calls=c) for us, k, c in rows[:10]])
    emit(phase="train_profile", config=label, size=size, batch=TRAIN_BATCH, step_kind=step_kind(cfg, step), **out)
    return out


# ---------------------------------------------------------------- phases 7-10: ADA, bCR, contrastive
AUG_BATCH = 2 * TRAIN_BATCH  # the fused D pass of the main path augments fakes and reals together
WARPS = {
    "conv": dict(method="conv"),
    "matmul": dict(method="matmul"),
    "matmul_1x_grid": dict(method="matmul", oversample_grid=False),
    "fft": dict(method="fft"),
}


def aug_inputs(batch: int, size: int, device: str, seed: int = 12):
    """Images and a cotangent in [-1, 1] from a numpy seed, and one
    AugmentParams draw at p = 0.5 (made on the CPU), all on `device`."""
    from maua_tpu_torch.train.augment import augment_params, draw_augment

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-1, 1, (batch, 3, size, size)).astype(np.float32))
    cot = torch.from_numpy(rng.uniform(-1, 1, (batch, 3, size, size)).astype(np.float32))
    params = augment_params(draw_augment(batch, torch.Generator().manual_seed(seed + 1), "cpu"), torch.tensor(0.5), size, size)
    return x.to(device), cot.to(device), type(params)(*(t.to(device) for t in params))


def phase_augment_card_vs_cpu() -> dict:
    """ADA's warps and colour matrix on the card against the CPU at the main
    path's fused D batch ([24, 3, 256, 256] fp32, one draw at p = 0.5, TF32
    off): each output and its input gradient (of <out, cotangent>) within
    1e-4; then the fft warp's two shear implementations on the card, dftmm
    against fft, in fp32 (1e-4) and bf16 (5e-2: bf16 DFT matrices)."""
    from maua_tpu_torch.train.augment import apply_affine, apply_color
    from maua_tpu_torch.train.fft_warp import affine_warp_fft

    cases = {name: (lambda x, p, kw=kw: apply_affine(x, p.affine, **kw)) for name, kw in WARPS.items()}
    cases["color"] = lambda x, p: apply_color(x, p.color)
    res, out = {}, {}
    with tf32_off():
        for dev in ("cpu", "cuda"):
            x, cot, params = aug_inputs(AUG_BATCH, TRAIN_SIZE, dev)
            for name, fn in cases.items():
                xr = x.clone().requires_grad_()
                y = fn(xr, params)
                require(y.device.type == dev, f"augment {name} ran on {y.device}, not {dev}")
                (gx,) = torch.autograd.grad((y * cot).sum(), xr)
                res.setdefault(name, {})[dev] = (y.detach().cpu(), gx.cpu())
                del xr, y, gx
        for name, r in res.items():
            (y_card, g_card), (y_cpu, g_cpu) = r["cuda"], r["cpu"]
            out[name] = dict(max_abs_err=(y_card - y_cpu).abs().max().item(), grad_max_abs_err=(g_card - g_cpu).abs().max().item(),
                             out_abs_max=y_cpu.abs().max().item(), grad_abs_max=g_cpu.abs().max().item())
            require(out[name]["max_abs_err"] <= 1e-4 and out[name]["grad_max_abs_err"] <= 1e-4,
                    f"augment {name}: card vs CPU {out[name]}")
        x, _, params = aug_inputs(AUG_BATCH, TRAIN_SIZE, "cuda")
        shear = {}
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
            a = affine_warp_fft(x.to(dtype), params.affine, shear_impl="fft").float()
            b = affine_warp_fft(x.to(dtype), params.affine, shear_impl="dftmm").float()
            shear[str(dtype).split(".")[1]] = err = (a - b).abs().max().item()
            require(err <= tol, f"fft warp, dftmm against fft in {dtype}: {err}")
    emit(phase="augment_card_vs_cpu", batch=AUG_BATCH, size=TRAIN_SIZE, p=0.5, precision="fp32, TF32 off",
         tolerance="card vs CPU 1e-4 (values and input gradients); dftmm vs fft 1e-4 fp32, 5e-2 bf16",
         card_vs_cpu=out, dftmm_vs_fft_max_abs_err=shear)
    return out


def phase_augment_times() -> dict:
    """CUDA-event medians of each warp, forward and forward + backward (the
    input gradient of <out, cotangent>), at the main path's fused D batch
    [24, 3, 256, 256] in fp32 and bf16; the fft warp's two shears; and the
    whole augment (fft warp + colour) at 1024^2, batch 8, the method `auto`
    picks on the card at every size."""
    from maua_tpu_torch.train.augment import apply_affine, augment
    from maua_tpu_torch.train.fft_warp import affine_warp_fft

    def fwd_bwd(fn, x, cot):
        xr = x.detach().requires_grad_()
        torch.autograd.grad((fn(xr).float() * cot).sum(), xr)

    times = {}
    with tf32_off():
        x32, cot, params = aug_inputs(AUG_BATCH, TRAIN_SIZE, "cuda")
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            fns = {name: (lambda a, kw=kw: apply_affine(a, params.affine, **kw)) for name, kw in WARPS.items()}
            fns["fft_dftmm_shear"] = lambda a: affine_warp_fft(a, params.affine, shear_impl="dftmm")
            for name, fn in fns.items():
                times[f"{name}_{str(dtype).split('.')[1]}"] = dict(
                    forward_ms=cuda_ms(lambda: fn(x), runs=10), forward_backward_ms=cuda_ms(lambda: fwd_bwd(fn, x, cot), runs=10))
            # the G pass augments its [12] fakes and takes the gradient back through the warp
            g_params = type(params)(*(t[:TRAIN_BATCH] for t in params))
            times[f"fft_b12_{str(dtype).split('.')[1]}"] = dict(forward_backward_ms=cuda_ms(
                lambda: fwd_bwd(lambda a: apply_affine(a, g_params.affine, method="fft"), x[:TRAIN_BATCH], cot[:TRAIN_BATCH]),
                runs=10))
        del x32, cot
        torch.cuda.empty_cache()
        x, cot, params = aug_inputs(8, 1024, "cuda")
        full = lambda a: augment(a, None, params=params, warp_method="fft")[0]  # noqa: E731
        times["augment_fft_1024_b8_float32"] = dict(forward_ms=cuda_ms(lambda: full(x), runs=5),
                                                    forward_backward_ms=cuda_ms(lambda: fwd_bwd(full, x, cot), runs=5))
        del x, cot
        torch.cuda.empty_cache()
    emit(phase="augment_times", batch=AUG_BATCH, size=TRAIN_SIZE, times_ms=times)
    return times


def grad_groups(names: list, card: list, cpu: list) -> dict:
    """Gradients by tensor, with G's per-layer noise weights (one scalar each)
    taken together as one vector: each of their gradients is one sum over
    every pixel of its layer, B x C x H x W terms of either sign that nearly
    cancel, so fp32 holds it to ~1e-2 of itself on one device against
    another, with or without ADA (over 8 draw seeds of the G phase at 32^2
    without ADA, 5 went past 1e-3 of themselves on an H100, while every other
    tensor stayed within 1e-3)."""
    groups = {n: (a, b) for n, a, b in zip(names, card, cpu) if not n.endswith("noise.weight")}
    noise = [(a.reshape(-1), b.reshape(-1)) for n, a, b in zip(names, card, cpu) if n.endswith("noise.weight")]
    if noise:
        groups["noise weights"] = (torch.cat([a for a, _ in noise]), torch.cat([b for _, b in noise]))
    return groups


def phase_train_ada_card_vs_cpu() -> dict:
    """One D, ADA and G update at 32^2 (channel_max 64, batch 4), card
    against CPU, D and G each from the same initial weights, with the same
    draws, with ADA's fft warp at p = 0.5: the adaptive config with p set to
    0.5 and 300 predictions already counted, so that the ADA phase updates
    p; then with bCR, and with the contrastive regularizer (momentum 0.99,
    queue 4 x batch). Tolerance as train_card_vs_cpu: losses rtol 1e-4, each gradient
    (D's and the head's, G's with its layer noise weights as one vector,
    `grad_groups`) max abs <= 1e-3 x its max abs + 1e-6; r_t and the sign
    sum equal. Beside them, how far the matrices each device assembles from
    the draws differ (sin, cos and exp differ in the last bits)."""
    from maua_tpu_torch.train import augment_params, draw_step, init_train_state, make_train_config, make_train_phases

    base = dict(size=32, channel_max=64, batch_size=4, constant_input=True, augment=True, ada_warp_method="fft")
    configs = {"ada": {}, "bcr": dict(bcr_weight=1.0),
               "contrastive": dict(contrastive_weight=0.1, contrastive_momentum=0.99, contrastive_queue=16)}
    real = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (1, 4, 3, 32, 32)).astype(np.float32))
    out = {}
    for label, over in configs.items():
        cfg = make_train_config(**base, **over)
        draws = draw_step(cfg, 0, torch.Generator().manual_seed(3), "cpu")
        assembly_err = max((pb.cpu() - pa).abs().max().item()
                           for draw in draws.d + draws.g for a in draw.aug
                           for pa, pb in zip(augment_params(a, torch.tensor(0.5), cfg.size, cfg.size),
                                             augment_params(to(a, "cuda"), torch.tensor(0.5, device="cuda"), cfg.size, cfg.size)))
        res = {}
        for dev in ("cpu", "cuda"):
            st = init_train_state(cfg, seed=1, device=dev)
            names = {"d": [n for n, _ in st.d.named_parameters()] +
                     ([] if st.cl_head is None else [f"cl_head.{n}" for n, _ in st.cl_head.named_parameters()]),
                     "g": [n for n, _ in st.g.named_parameters()]}
            st.ada_p, st.ada_n = torch.tensor(0.5, device=dev), torch.tensor(300.0, device=dev)
            ph = make_train_phases(cfg)
            d_aux, d_grads = ph["d"](st, to(real, dev), to(draws.d, dev))
            r_t = ph["ada"](st, d_aux)
            # the G phase from the initial weights too, as train_card_vs_cpu runs each
            # phase: after one Adam step (b1 = 0), D's elements whose gradient is
            # near 0 move by +-lr on either device by the sign of rounding noise
            st = init_train_state(cfg, seed=1, device=dev)
            st.ada_p = torch.tensor(0.5, device=dev)
            g_loss, g_grads = ph["g"](st, to(draws.g, dev))
            res[dev] = dict(d=(float(d_aux["d_loss"]), [g.detach().cpu() for g in d_grads]),
                            g=(float(g_loss), [g.detach().cpu() for g in g_grads]),
                            ada=[float(v) for v in (r_t, d_aux["sign_sum"])])
        out[label] = {}
        for name in ("d", "g"):
            (l_cpu, g_cpu), (l_card, g_card) = res["cpu"][name], res["cuda"][name]
            require(abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu) + 1e-7, f"{label} {name} loss: card {l_card} vs CPU {l_cpu}")
            require(all(bool(torch.isfinite(a).all()) for a in g_card), f"{label} {name}: card gradients are finite")
            groups = grad_groups(names[name], g_card, g_cpu)
            for group, (a, b) in groups.items():
                err, scale = (a - b).abs().max().item(), b.abs().max().item()
                require(err <= 1e-3 * scale + 1e-6,
                        f"{label} {name}: card vs CPU gradient {group} {tuple(b.shape)}: max abs err {err} against max abs {scale}")
            rel = {n: ((a - b).abs().max() / (b.abs().max() + 1e-12)).item() for n, a, b in zip(names[name], g_card, g_cpu)}
            out[label][name] = dict(loss_cpu=l_cpu, loss_card=l_card,
                                    grad_max_abs_err=max((a - b).abs().max().item() for a, b in zip(g_card, g_cpu)),
                                    grad_max_rel_err=max(((a - b).abs().max() / (b.abs().max() + 1e-12)).item()
                                                         for a, b in groups.values()),
                                    worst_single_tensor=max(rel.items(), key=lambda kv: kv[1]))
        require(res["cuda"]["ada"] == res["cpu"]["ada"], f"{label} ADA r_t and sign sum: {res['cuda']['ada']} vs {res['cpu']['ada']}")
        out[label]["ada"] = dict(r_t=res["cuda"]["ada"][0], sign_sum=res["cuda"]["ada"][1])
        out[label]["matrix_assembly_max_abs_err"] = assembly_err
    # why G's noise weights are judged together: the G phase without ADA over
    # 8 draw seeds, each tensor's card-vs-CPU max abs error over its max abs
    sweep = {}
    cfg = make_train_config(**{**base, "augment": False})
    for seed in range(3, 11):
        draws = draw_step(cfg, 0, torch.Generator().manual_seed(seed), "cpu")
        grads = {}
        for dev in ("cpu", "cuda"):
            st = init_train_state(cfg, seed=1, device=dev)
            grads[dev] = make_train_phases(cfg)["g"](st, to(draws.g, dev))[1]
        rel = {n: ((a.cpu() - b).abs().max() / (b.abs().max() + 1e-12)).item()
               for (n, _), a, b in zip(st.g.named_parameters(), grads["cuda"], grads["cpu"])}
        sweep[seed] = dict(worst_noise_weight=max(v for n, v in rel.items() if n.endswith("noise.weight")),
                           worst_other=max(v for n, v in rel.items() if not n.endswith("noise.weight")))
    out["g_without_ada_by_seed"] = sweep
    emit(phase="train_ada_card_vs_cpu", size=32, channel_max=64, batch=4, p=0.5, warp="fft", precision="exact fp32",
         tolerance="loss rtol 1e-4; grad max abs <= 1e-3 x max abs + 1e-6 (G's noise weights as one vector); r_t and sign sum equal",
         configs=out)
    return out


def write_png_folder(folder: str, n: int, seed: int) -> None:
    """n PNGs of 288 x 320 (smooth colour fields plus noise, from a numpy
    seed), written with OpenCV: prepare_data centre-crops and resizes them."""
    import cv2

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:288, 0:320] / 64.0
    for i in range(n):
        f = rng.uniform(0.5, 3.0, (3, 2))
        img = np.stack([np.sin(f[c, 0] * yy + i) * np.cos(f[c, 1] * xx - c) for c in range(3)], axis=-1)
        img = 127.5 * (img + 1) + rng.normal(0, 8, img.shape)
        cv2.imwrite(os.path.join(folder, f"img{i:03d}.png"), np.clip(img, 0, 255).astype(np.uint8))


def ada_p_on_host(log: list, target: float = 0.6, length: float = 15_000.0, threshold: float = 256.0) -> list:
    """p after each logged step, recomputed in float32 on the host from the
    logged sign sums and counts by ada_adjust_p's rule."""
    f = np.float32
    p, signs, n, out = f(0), f(0), f(0), []
    for x in log:
        signs, n = f(signs + f(x["sign_sum"])), f(n + f(x["n_pred"]))
        if n > threshold:
            r_t = f(signs / max(n, f(1)))
            p = f(np.clip(f(p + f(1.0 if r_t > target else -1.0) * f(target / length) * n), 0, 1))
            signs, n = f(0), f(0)
        out.append(p)
    return out


def phase_train_ada_main_path(tmp: str) -> dict:
    """The train CLI's default configuration (ADA on, `--ada_warp auto` = the
    fft warp on the card) at 256^2, full width, batch 12, on 48 raw shards
    that the port's prepare_data makes from a folder of PNGs. (a) fp32 and
    bf16 with --augment_p 0.5, 8 steps each: s/step by kind, imgs/s over the
    16-step cycle, peak memory, launches per step against the structure;
    (b) bf16, adaptive p from 0, 24 steps: p updates at the first step whose
    count passes 256 predictions (step 21, 12 per step) to the value
    ada_adjust_p gives from the logged sign sums; (c) bf16 with bCR 1,
    contrastive 0.1, momentum 0.99 and a queue of 48, 4 steps. Then the
    profile of one R1 + path step with ADA in fp32 and bf16 with the fft
    warp's kernels' share, and the launch shapes of an fp32 ADA step."""
    from maua_tpu_torch.data import prepare_data
    from maua_tpu_torch.train import draw_step, make_train_step
    from maua_tpu_torch.train.cli import build_parser, train_loop

    pngs, shards = os.path.join(tmp, "pngs"), os.path.join(tmp, "ada_shards")
    t0 = time.perf_counter()
    write_png_folder(pngs, 48, seed=21)
    n = prepare_data(pngs, shards, sizes=(TRAIN_SIZE,), n_workers=2, shard_size=24, fmt="raw")
    require(n == 48 and len(os.listdir(shards)) == 2, f"prepare_data wrote {n} images, {os.listdir(shards)}")
    emit(phase="train_ada_data", size=TRAIN_SIZE, images=n, shards=sorted(os.listdir(shards)), seconds=time.perf_counter() - t0)

    def argv(run, iters, *extra):
        return ["--path", shards, "--size", str(TRAIN_SIZE), "--batch_size", str(TRAIN_BATCH), "--iter", str(iters),
                "--log_every", "1", "--img_every", "0", "--checkpoint_every", "0", "--num_workers", "4",
                "--device", "cuda", "--run_dir", run, *extra]

    def counted_run(label, iters, *extra):
        with contextlib.redirect_stdout(io.StringIO()):  # warm-up: one step with R1 and the path penalty
            train_loop(build_parser().parse_args(argv(os.path.join(tmp, f"warm_{label}"), 1, *extra)))
        run = os.path.join(tmp, f"run_{label}")
        cfg = resolved_config(argv(run, iters, *extra))
        require(cfg.augment and cfg.ada_warp_method == "fft", f"{label}: resolved ADA {cfg.augment} {cfg.ada_warp_method}")
        return dict(counted_train_run(argv(run, iters, *extra), cfg, iters, label), cfg=cfg)

    results, profile, shapes = {}, {}, None
    gen_draws = torch.Generator(device="cuda").manual_seed(11)
    u8 = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (1, TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3), dtype=np.uint8)).cuda()
    # (a) fixed p = 0.5
    for label, extra in (("fp32_exact", ()), ("bf16", ("--bf16",))):
        r = counted_run(f"ada_{label}", TRAIN_STEPS, "--augment_p", "0.5", *extra)
        cycle = (r["s_step"]["r1_path"] + 3 * r["s_step"]["path"] + 12 * r["s_step"]["plain"]) / 16
        per_kind = launches_per_kind(r["cfg"], (("r1_path", 0), ("path", 4), ("plain", 1)))
        results[f"a_{label}"] = dict(launches=r["launches"], fir_launches=r["fir_launches"], s_step=r["s_step"],
                                     cycle_s=cycle, peak_gb=r["peak_gb"])
        emit(phase="train_ada_main_path", run="a", config=label, size=TRAIN_SIZE, batch=TRAIN_BATCH, augment_p=0.5, warp="fft",
             steps=TRAIN_STEPS, launches=dict(zip(("forward", "gradient"), r["launches"]), upfirdn2d=r["fir_launches"]),
             launches_per_step_kind=per_kind,
             s_per_step=r["s_step"], imgs_per_s={k: TRAIN_BATCH / v for k, v in r["s_step"].items()},
             imgs_per_s_16_step_cycle=TRAIN_BATCH / cycle, run_wall_s=r["wall_s"], peak_memory_gb=r["peak_gb"],
             losses_last={k: r["lines"][-1][k] for k in ("Generator", "Discriminator")})
        state, cfg = r["state"], r["cfg"]
        step_fn = make_train_step(cfg)
        if label == "fp32_exact":
            state.step = 16 * 10
            shapes = record_launch_shapes(lambda: step_fn(state, u8, draw_step(cfg, state.step, gen_draws, "cuda")))
        profile[label] = profile_train_step(step_fn, state, u8, cfg, gen_draws, f"ada_{label}", 16 * 11)
        del r, state, step_fn
        torch.cuda.empty_cache()

    # (b) adaptive p from 0
    r = counted_run("ada_adaptive", 24, "--bf16")
    host_p = ada_p_on_host(r["lines"])
    logged_p = [x["Augment"] for x in r["lines"]]
    first = next(i for i, x in enumerate(np.cumsum([x["n_pred"] for x in r["lines"]])) if x > 256)
    require(first == 21, f"(b) the count passes 256 at step {first}")
    require(all(p == 0.0 for p in logged_p[:first]), f"(b) p moved before step {first}: {logged_p[:first]}")
    require(all(abs(a - b) <= 1e-7 for a, b in zip(logged_p, host_p)), f"(b) p {logged_p} vs ada_adjust_p on the host {host_p}")
    # the update reset the counts: the next step's r_t is its own sign sum over its own 12 predictions
    nxt = r["lines"][first + 1]
    require(nxt["Rt"] == np.float32(nxt["sign_sum"]) / np.float32(nxt["n_pred"]), f"(b) counts not reset after step {first}: {nxt}")
    r_t_update = r["lines"][first]["Rt"]
    # p moves up from 0 when r_t > the 0.6 target; below it the step down is clipped at 0
    require((logged_p[first] > 0.0) == (r_t_update > 0.6), f"(b) p {logged_p[first]} at r_t {r_t_update}")
    results["b"] = dict(p=logged_p, p_host=[float(p) for p in host_p], update_step=first, s_step=r["s_step"])
    emit(phase="train_ada_main_path", run="b", config="bf16", augment_p="adaptive", steps=24, update_step=first,
         r_t_at_update=r_t_update, p_moved=logged_p[first] > 0.0, p_per_step=logged_p, p_host=[float(p) for p in host_p], rt_per_step=[x["Rt"] for x in r["lines"]],
         sign_sum_per_step=[x["sign_sum"] for x in r["lines"]], s_per_step=r["s_step"], peak_memory_gb=r["peak_gb"])
    del r
    torch.cuda.empty_cache()

    # (c) bCR + contrastive with MoCo
    flags = ("--bf16", "--augment_p", "0.5", "--balanced_consistency", "1", "--contrastive", "0.1",
             "--contrastive_momentum", "0.99", "--contrastive_queue", "48")
    r = counted_run("bcr_contrastive", 4, *flags)
    require(int(r["state"].cl_state.queue_filled) == 48, f"(c) queue filled {int(r['state'].cl_state.queue_filled)}")
    results["c"] = dict(s_step=r["s_step"], launches=r["launches"], peak_gb=r["peak_gb"])
    emit(phase="train_ada_main_path", run="c", config="bf16", bcr=1.0, contrastive=0.1, contrastive_momentum=0.99,
         contrastive_queue=48, steps=4,
         launches=dict(zip(("forward", "gradient"), r["launches"]), upfirdn2d=r["fir_launches"]),
         launches_per_step=[(*expected_launches(r["cfg"], i), expected_fir_launches(r["cfg"], i)) for i in range(4)],
         s_per_step=r["s_step"],
         peak_memory_gb=r["peak_gb"], losses={k: [x[k] for x in r["lines"]] for k in ("Generator", "Discriminator")})
    del r
    torch.cuda.empty_cache()
    return {"results": results, "profile": profile, "shapes": shapes}


# ---------------------------------------------------------------- phases 11, 12: generate()
SR = 22050
GEN_SIZE, TRACK_S = 1024, 180.0  # the FFHQ-1024 checkpoint of phase 4; the whole track of (a)
TOOLS_SIZE = GEN_SIZE


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
    fir = fir_module()
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
            fir_expected = fir_per_pass(GEN_SIZE) * batches  # the same layers at any out_size
            CountingWriter.written = []
            torch.cuda.synchronize()
            fused_act.launches = fused_act.grad_launches = fir.launches = 0
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
            require(fir.launches == fir_expected, f"({label}) upfirdn2d launched {fir.launches} times, expected {fir_expected}")
            require(len(CountingWriter.written) == n_frames and min(CountingWriter.written) > 0,
                    f"({label}) {len(CountingWriter.written)} frames written")
            latents, noise = calls["timelines"]
            results[label] = dict(frames=n_frames, batch=kw["batch"], out_size=kw["out_size"], launches=launches,
                                  expected_launches=expected, upfirdn2d_launches=fir.launches, wall_s=wall, frames_per_s=n_frames / wall,
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


def forward_shape_rows(counts, seen: set) -> list:
    """The forward kernel against its plain version (fp32, exact) at each
    launch shape of `counts` (a Counter of (shape, dtype, bias)) not in
    `seen`, which it extends: error, times and bound per shape."""
    from maua_tpu_torch.ops.fused_act import fused_bias_act, fused_leaky_relu_plain

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
        rows.append(dict(kernel="fused_bias_act", shape=list(shape), launches=n,
                         max_abs_err=(got - want).abs().max().item(),
                         ms=fast_ms(lambda: fused_bias_act(x, b), x.numel()),
                         plain_ms=fast_ms(lambda: fused_leaky_relu_plain(x, b), x.numel()),
                         bound_ms=moved / HBM_BYTES_PER_S * 1e3))
        del x, b, got, want
        torch.cuda.empty_cache()
    return rows


def held_shapes() -> set:
    """The forward kernel's shapes phase 2 holds: a render batch and the mapping."""
    return {s for s, _ in render_batch_shapes(8)} | {(8, 512), (16384, 512)}


def phase_kernels_generate(shapes: dict) -> dict:
    """The forward kernel at every launch shape of generate() runs (b) and (c)
    that the render phase did not already hold: kernel vs plain, fp32."""
    from collections import Counter

    counts = Counter()
    for fwd in shapes.values():
        counts.update(fwd)
    rows = forward_shape_rows(counts, held_shapes())
    emit(phase="kernel_generate", kernel="fused_bias_act", dtype="float32", shapes=rows)
    return {"shapes": rows}


# ---------------------------------------------------------------- phases 13, 14: inference tools, StyleGAN1, TF pickles, evaluation
def vgg16_features_sd(seed: int) -> dict:
    """A torchvision-layout vgg16 `features.*` state dict from a numpy seed
    (He-normal convs, small biases): LPIPS's backbone."""
    from maua_tpu_torch.eval import LPIPS

    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in LPIPS("vgg").state_dict().items():
        if k.startswith("features."):
            shape = tuple(v.shape)
            scale = math.sqrt(2.0 / np.prod(shape[1:])) if len(shape) > 1 else 0.05
            sd[k] = torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))
    return sd


def inception_sd(seed: int) -> dict:
    """A torchvision-layout InceptionV3 state dict from a numpy seed:
    He-normal convs and batch norms near identity, so the pool3 features stay
    alive through the 94 convs (a random lecun-normal net collapses them)."""
    from maua_tpu_torch.eval import InceptionV3

    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in InceptionV3().state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("conv.weight"):
            a = math.sqrt(2.0 / np.prod(shape[1:])) * rng.standard_normal(shape)
        elif k.endswith("bn.weight"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif k.endswith(("bn.bias", "bn.running_mean")):
            a = 0.05 * rng.standard_normal(shape)
        elif k.endswith("bn.running_var"):
            a = 1.0 + 0.1 * rng.random(shape)
        else:
            continue
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


def fabricate_sg1_checkpoint(path: str, size: int, seed: int) -> None:
    """A lernapparat G_style state dict of the FFHQ StyleGAN1 configuration
    (nf(stage) = min(8192 / 2^stage, 512)) from a numpy seed: mapping weights
    N(0, 100^2) (lr multiplier 0.01), N(0, 1) conv and style weights, small
    biases and noise weights."""
    from maua_tpu_torch.models.stylegan1 import StyleGAN1, nf

    log = int(math.log2(size))
    template = StyleGAN1(size, [nf(r - 1) for r in range(2, log + 1)])
    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in template.state_dict().items():
        if name.startswith("noises."):
            continue
        v = rng.standard_normal(tuple(t.shape), dtype=np.float32)
        if name.startswith("g_mapping.") and name.endswith(".weight"):
            v = 100.0 * v
        elif name.endswith(".bias") or name.endswith("noise.weight"):
            v = 0.1 * v
        sd[name] = torch.from_numpy(v)
    torch.save(sd, path)


def fabricate_tf_pickle(path: str, size: int, seed: int) -> None:
    """A TF StyleGAN2 `Gs` pickle of the FFHQ config (style_dim 512, 8
    mapping layers, channel multiplier 2) from a numpy seed, written through
    stand-in dnnlib modules that are removed again, so that the port reads it
    without dnnlib."""
    import pickle
    import types

    from maua_tpu_torch.models import channel_map

    rng = np.random.default_rng(seed)
    ch = channel_map(CHANNEL_MULTIPLIER)
    variables = []

    def put(name, shape, scale=1.0):
        variables.append((name, (scale * rng.standard_normal(shape)).astype(np.float32)))

    for i in range(N_MLP):
        put(f"G_mapping/Dense{i}/weight", (STYLE_DIM, STYLE_DIM))
        put(f"G_mapping/Dense{i}/bias", (STYLE_DIM,), 0.1)
    put("G_synthesis/4x4/Const/const", (1, ch[4], 4, 4))

    def conv(prefix, cin, cout, k=3, rgb=False):
        put(f"{prefix}/weight", (k, k, cin, cout))
        put(f"{prefix}/mod_weight", (STYLE_DIM, cin))
        put(f"{prefix}/mod_bias", (cin,), 0.1)
        put(f"{prefix}/bias", (cout,), 0.1)
        if not rgb:
            variables.append((f"{prefix}/noise_strength", np.float32(0.1 * rng.standard_normal())))

    conv("G_synthesis/4x4/Conv", ch[4], ch[4])
    conv("G_synthesis/4x4/ToRGB", ch[4], 3, k=1, rgb=True)
    for i in range(int(math.log2(size)) - 2):
        r = 4 * 2 ** (i + 1)
        conv(f"G_synthesis/{r}x{r}/Conv0_up", ch[r // 2], ch[r])
        conv(f"G_synthesis/{r}x{r}/Conv1", ch[r], ch[r])
        conv(f"G_synthesis/{r}x{r}/ToRGB", ch[r], 3, k=1, rgb=True)
    for i in range((int(math.log2(size)) - 2) * 2 + 1):
        put(f"G_synthesis/noise{i}", (1, 1, 2 ** ((i + 5) // 2), 2 ** ((i + 5) // 2)))

    names = ("dnnlib", "dnnlib.tflib", "dnnlib.tflib.network")
    mods = {n: types.ModuleType(n) for n in names}

    class Network:
        def __init__(self, state):
            self._state = state

        def __getstate__(self):
            return self._state

    Network.__module__, Network.__qualname__ = "dnnlib.tflib.network", "Network"
    mods["dnnlib.tflib.network"].Network = Network
    sys.modules.update(mods)
    try:
        gs = Network({"name": "Gs", "static_kwargs": {"resolution": size}, "variables": variables, "components": {}})
        with open(path, "wb") as f:
            pickle.dump((None, None, gs), f)
    finally:
        for n in names:
            sys.modules.pop(n, None)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest difference over the largest magnitude."""
    return ((a.float().cpu() - b.float().cpu()).abs().max() / b.float().cpu().abs().max().clamp_min(1e-30)).item()


def phase_tools_card_vs_cpu(tmp: str) -> None:
    """The new modules, card against CPU in exact fp32 (TF32 off) at 256^2:
    LPIPS vgg and alex distances, Inception pool3 features in both variants,
    the StyleGAN1 synthesis at full width, the projector's first step (its
    loss, and the gradients of the W+ latent and of the noise maps as one
    vector) through the 256^2 generator of phase 3 with LPIPS-VGG, and the
    TF-pickle conversion (equal state dicts, images within 1e-3)."""
    from maua_tpu_torch.eval import LPIPS, InceptionV3
    from maua_tpu_torch.io import load_generator, load_tf_generator
    from maua_tpu_torch.models import load_stylegan1, noise_shapes
    from maua_tpu_torch.models.blocks import tf32
    from maua_tpu_torch.pipeline.projector import projector_loss

    out = {}
    rng = np.random.default_rng(31)
    x = torch.from_numpy(np.tanh(rng.standard_normal((2, 3, 256, 256))).astype(np.float32))
    y = torch.from_numpy(np.tanh(x.numpy() + 0.3 * rng.standard_normal((2, 3, 256, 256))).astype(np.float32))
    vgg_sd = vgg16_features_sd(32)
    with tf32(conv=False, matmul=False), torch.no_grad():
        for net in ("vgg", "alex"):
            sd = vgg_sd if net == "vgg" else None  # alex: its seeded initial backbone on both devices
            lp = LPIPS(net).load(sd)
            a, b = lp.cuda()(x.cuda(), y.cuda()), lp.cpu()(x, y)
            out[f"lpips_{net}"] = rel_err(a, b)
            require(bool((b > 0).all()) and out[f"lpips_{net}"] <= 1e-4, f"LPIPS {net}: card vs CPU {out[f'lpips_{net}']}")
        inc_sd = inception_sd(33)
        for fid_variant in (False, True):
            net = InceptionV3(fid_variant=fid_variant).load(inc_sd).eval()
            a = net.cuda()(InceptionV3.preprocess(x.cuda()))
            b = net.cpu()(InceptionV3.preprocess(x))
            key = "inception_fid" if fid_variant else "inception"
            out[key] = rel_err(a, b)
            require(b.abs().max() > 1e-2 and out[key] <= 1e-4, f"{key}: card vs CPU {out[key]} (features max {b.abs().max()})")

        sg1_path = os.path.join(tmp, "sg1_256.pt")
        fabricate_sg1_checkpoint(sg1_path, 256, seed=34)
        z = torch.from_numpy(rng.standard_normal((2, STYLE_DIM)).astype(np.float32))
        card, cpu = load_stylegan1(sg1_path, device="cuda"), load_stylegan1(sg1_path, device="cpu")
        fir_ops = fir_module()
        torch.cuda.synchronize()
        fir_before = fir_ops.launches
        a, b = card(z.cuda(), input_is_latent=False)[0], cpu(z, input_is_latent=False)[0]
        require(fir_ops.launches - fir_before == sg1_fir_per_pass(256),
                f"StyleGAN1 256^2: {fir_ops.launches - fir_before} upfirdn2d launches, derived {sg1_fir_per_pass(256)}")
        out["stylegan1_256_max_abs"] = (a.cpu() - b).abs().max().item()
        require(bool(torch.isfinite(a).all()) and out["stylegan1_256_max_abs"] <= 1e-3,
                f"StyleGAN1 256^2: card vs CPU max abs {out['stylegan1_256_max_abs']}")
        del card, cpu

        pkl = os.path.join(tmp, "gs256.pkl")
        fabricate_tf_pickle(pkl, 256, seed=35)
        card, cpu = load_tf_generator(pkl, device="cuda"), load_tf_generator(pkl, device="cpu")
        sd_a, sd_b = card.state_dict(), cpu.state_dict()
        require(set(sd_a) == set(sd_b) and all(torch.equal(sd_a[k].cpu(), sd_b[k]) for k in sd_b), "TF pickle: state dicts differ")
        a = card(z.cuda(), randomize_noise=False)[0]
        b = cpu(z, randomize_noise=False)[0]
        out["tf_pickle_256_max_abs"] = (a.cpu() - b).abs().max().item()
        require(out["tf_pickle_256_max_abs"] <= 1e-3, f"TF pickle 256^2: card vs CPU {out['tf_pickle_256_max_abs']}")
        del card, cpu

    # the projector's first step: loss and gradients, from the same latent,
    # noise maps and latent-noise draw on both devices
    g_path = os.path.join(tmp, "g256.pt")
    grads = {}
    lp_sd = vgg_sd
    target = torch.from_numpy(np.tanh(rng.standard_normal((1, 3, 256, 256))).astype(np.float32))
    latent0 = torch.from_numpy(0.5 * rng.standard_normal((1, 14, STYLE_DIM)).astype(np.float32))
    noises0 = [torch.from_numpy(rng.standard_normal((1,) + s[1:]).astype(np.float32)) for s in noise_shapes(256)]
    draw = torch.from_numpy(rng.standard_normal((1, 14, STYLE_DIM)).astype(np.float32))
    for dev in ("cuda", "cpu"):
        gen = load_generator(g_path, device=dev)
        lp = LPIPS("vgg").load(lp_sd).requires_grad_(False).eval().to(dev)
        latent = latent0.to(dev).requires_grad_(True)
        noises = [n.to(dev).requires_grad_(True) for n in noises0]
        with tf32(conv=False, matmul=False):
            loss, (d, n_reg) = projector_loss(gen, target.to(dev), latent, noises, draw.to(dev), 0.05, lp)
            g = torch.autograd.grad(loss, [latent, *noises])
        grads[dev] = (loss.detach().cpu(), d.detach().cpu(), g[0].cpu(), torch.cat([t.flatten() for t in g[1:]]).cpu())
        del gen, lp
    (la, da, gla, gna), (lb, db, glb, gnb) = grads["cuda"], grads["cpu"]
    out["projector_loss_rel"] = rel_err(la, lb)
    out["projector_latent_grad_rel"] = rel_err(gla, glb)
    out["projector_noise_grad_rel"] = rel_err(gna, gnb)
    require(out["projector_loss_rel"] <= 1e-4, f"projector loss card vs CPU {out['projector_loss_rel']}")
    require(out["projector_latent_grad_rel"] <= 1e-3 and out["projector_noise_grad_rel"] <= 1e-3,
            f"projector gradients card vs CPU {out}")
    emit(phase="tools_card_vs_cpu", size=256, precision="exact fp32", errors=out,
         tolerance="LPIPS, Inception 1e-4 of the largest; images 1e-3 max abs; projector loss 1e-4, gradients 1e-3 "
                   "of the largest (noise maps as one vector)")


def counted(fn, label: str, fwd: int, grad: int = 0, fir: int = 0):
    """(result, seconds, forward Counter, gradient Counter) of fn() on the
    card, the launch counters set to 0 just before and read just after, and
    required to equal the counts derived from the structure: `fwd` and
    `grad` of the bias-act kernels, `fir` of upfirdn2d."""
    from maua_tpu_torch.ops import fused_act

    fir_ops = fir_module()
    torch.cuda.synchronize()
    fused_act.launches = fused_act.grad_launches = fir_ops.launches = 0
    box = {}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        shapes = record_launch_shapes(lambda: box.setdefault("out", fn()))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = (fused_act.launches, fused_act.grad_launches, fir_ops.launches)
    require(got == (fwd, grad, fir), f"{label}: launches {got}, derived from the structure {(fwd, grad, fir)}")
    return box["out"], seconds, shapes, buf.getvalue()


def phase_tools_main_path(tmp: str, ada_shards: str) -> dict:
    """The inference tools, StyleGAN1, TF pickles and evaluation at full
    width (FFHQ-1024 config of phase 4, random weights), through their
    public entry points on the card, each with its forward (and gradient)
    kernel launches derived from the structure: 25 per forward from z (8
    mapping layers + 17 StyledConvs), 17 per forward from W+, 8 per mean
    latent. (a) sample 64 images, truncation 0.7; (b) project a 1024^2
    target for 100 steps with LPIPS-VGG on 256^2 resizes; (c) a 10 s
    interpolation video at 30 fps with segmented noise; (d)
    generate_and_select 24 images; (e) generate(stylegan1=True) over a 4 s
    window of the phase-12 track with the FFHQ StyleGAN1, and
    load_tf_generator of a full-width Gs pickle; (f) the eval CLI's
    inception (512 prepared 256^2 images), fid (1024 samples) and ppl (256
    pairs, LPIPS-VGG), in exact and fast; (g) the default train CLI with
    --eval_every and SWD."""
    from maua_tpu_torch.data.synthetic import write_synth_shards
    from maua_tpu_torch.eval import cli as eval_cli
    from maua_tpu_torch.eval import perceptual_lpips
    from maua_tpu_torch.io import load_generator, load_tf_generator
    from maua_tpu_torch.ops.resize import resize_bilinear
    from maua_tpu_torch.pipeline import generate
    from maua_tpu_torch.pipeline.interpolate import interpolation_video
    from maua_tpu_torch.pipeline.projector import project
    from maua_tpu_torch.pipeline.sample import sample
    from maua_tpu_torch.pipeline.select_latents import generate_and_select
    from maua_tpu_torch.train.cli import build_parser, train_loop

    ckpt = os.path.join(tmp, "g1024.pt")
    per_w = 2 * (int(math.log2(TOOLS_SIZE)) - 2) + 1  # StyledConvs of one forward from W+
    per_z = N_MLP + per_w
    fir_w = fir_per_pass(TOOLS_SIZE)  # upfirdn2d calls of one synthesis
    CountingWriter = install_counting_writer()
    results, shapes = {}, {}

    # (a) sample
    pics, batch = 64, 8
    out_dir = os.path.join(tmp, "sample")
    _, s, shapes["a"], _ = counted(lambda: sample(ckpt, pics=pics, sample_batch=batch, truncation=0.7, out_dir=out_dir,
                                                  seed=1, device="cuda"), "(a) sample", N_MLP + (pics // batch) * per_z,
                                  fir=(pics // batch) * fir_w)
    from PIL import Image

    pngs = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
    im = np.asarray(Image.open(os.path.join(out_dir, "000063.png")))
    require(len(pngs) == pics + 1 and im.shape == (TOOLS_SIZE, TOOLS_SIZE, 3) and im.std() > 0, f"(a) {len(pngs)} PNGs")
    results["a_sample"] = dict(images=pics, batch=batch, seconds=s, images_per_s=pics / s)
    emit(phase="tools_main_path", run="a_sample", **results["a_sample"])

    # (b) project
    gen = load_generator(ckpt, device="cuda")
    lp = perceptual_lpips(vgg16_features_sd(32), net="vgg", device="cuda")
    with torch.no_grad():
        target = gen(torch.from_numpy(np.random.default_rng(36).standard_normal((1, STYLE_DIM)).astype(np.float32)).cuda(),
                     randomize_noise=False)[0]

    def lpips_256(img, t):
        return lp(resize_bilinear(img, (256, 256)), resize_bilinear(t, (256, 256)))

    steps = 100
    (latent, noises, hist), s, shapes["b"], _ = counted(
        lambda: project(gen, target, n_steps=steps, distance_fn=lpips_256, log_every=10), "(b) project",
        N_MLP + per_w * steps, per_w * steps, fir=2 * fir_w * steps)
    require(latent.shape == (1, gen.n_latent, STYLE_DIM) and len(noises) == gen.num_layers, "(b) shapes")
    require(all(np.isfinite(h["loss"]) for h in hist) and hist[-1]["dist"] < hist[0]["dist"],
            f"(b) the distance did not fall: {[h['dist'] for h in hist]}")
    results["b_project"] = dict(steps=steps, seconds=s, s_per_step=s / steps, dist=[h["dist"] for h in hist],
                                launches_per_step=(per_w, per_w))
    emit(phase="tools_main_path", run="b_project", size=TOOLS_SIZE, distance="lpips-vgg at 256^2", **results["b_project"])
    del gen, lp, latent, noises
    torch.cuda.empty_cache()

    # (c) interpolation video, segmented noise
    n_frames, batch = 300, 8
    CountingWriter.written = []
    out, s, _, _ = counted(lambda: interpolation_video(ckpt, n_latents=8, duration=10.0, fps=30, batch=batch,
                                                        noise_mode="segmented", output_file=os.path.join(tmp, "interp.mp4"),
                                                        device="cuda"),
                           "(c) interpolation_video", N_MLP + -(-n_frames // batch) * per_w,
                           fir=-(-n_frames // batch) * fir_w)
    require(len(CountingWriter.written) == n_frames and min(CountingWriter.written) > 0, f"(c) {len(CountingWriter.written)} frames")
    results["c_interpolate"] = dict(frames=n_frames, seconds=s, frames_per_s=n_frames / s, writer=CountingWriter.backend_used)
    emit(phase="tools_main_path", run="c_interpolate", size=TOOLS_SIZE, noise="segmented", **results["c_interpolate"])

    # (d) generate_and_select
    sel_dir = os.path.join(tmp, "selection")
    outs, s, _, _ = counted(lambda: generate_and_select(ckpt, n=24, out_dir=sel_dir, picks={"intro": [0, 3], "drop": [5]},
                                                        batch=8, device="cuda"),
                            "(d) generate_and_select", 2 * N_MLP + 3 * per_w, fir=3 * fir_w)
    require(np.load(outs["all"]).shape == (24, 18, STYLE_DIM) and np.load(outs["intro"]).shape == (2, 18, STYLE_DIM),
            "(d) latent files")
    results["d_select"] = dict(images=24, seconds=s, images_per_s=24 / s)
    emit(phase="tools_main_path", run="d_select", **results["d_select"])

    # (e) StyleGAN1 through generate(), and a full-width TF pickle
    sg1 = os.path.join(tmp, "sg1_1024.pt")
    fabricate_sg1_checkpoint(sg1, TOOLS_SIZE, seed=37)
    n_frames = 120
    CountingWriter.written = []
    _, s, _, _ = counted(lambda: generate(sg1, os.path.join(tmp, "track.wav"), stylegan1=True, G_res=TOOLS_SIZE,
                                          out_size=TOOLS_SIZE, offset=60.0, duration=4.0, fps=30, batch=8,
                                          output_file=os.path.join(tmp, "sg1.mp4"), device="cuda"),
                         "(e) generate(stylegan1=True)", 0,  # StyleGAN1's leaky-ReLU is plain
                         fir=sg1_fir_per_pass(TOOLS_SIZE) * (n_frames // 8))
    require(len(CountingWriter.written) == n_frames and min(CountingWriter.written) > 0, f"(e) {len(CountingWriter.written)} frames")
    results["e_stylegan1"] = dict(frames=n_frames, seconds=s, frames_per_s=n_frames / s)
    pkl = os.path.join(tmp, "gs1024.pkl")
    t0 = time.perf_counter()
    fabricate_tf_pickle(pkl, TOOLS_SIZE, seed=38)
    write_s = time.perf_counter() - t0
    tf_gen, load_s, _, _ = counted(lambda: load_tf_generator(pkl, device="cuda"), "(e) load_tf_generator", 0)
    with torch.no_grad():
        img, _ = counted(lambda: tf_gen(torch.zeros(2, STYLE_DIM, device="cuda").normal_(), randomize_noise=False),
                         "(e) TF-pickle generator forward", per_z, fir=fir_w)[0]
    require(img.shape == (2, 3, TOOLS_SIZE, TOOLS_SIZE) and bool(torch.isfinite(img).all()), "(e) TF-pickle generator image")
    results["e_tf_pickle"] = dict(bytes=os.path.getsize(pkl), write_s=write_s, load_tf_generator_s=load_s)
    emit(phase="tools_main_path", run="e_stylegan1", size=TOOLS_SIZE, window_s=4.0, **results["e_stylegan1"],
         tf_pickle=results["e_tf_pickle"])
    del tf_gen, img
    torch.cuda.empty_cache()

    # (f) the eval CLI, exact and fast
    eval_shards = os.path.join(tmp, "eval_shards")
    write_synth_shards(eval_shards, 256, 512, seed=39, shard_size=256)
    inc_w, lp_w = os.path.join(tmp, "inception_v3.pth"), os.path.join(tmp, "vgg16.pth")
    torch.save(inception_sd(33), inc_w)
    torch.save(vgg16_features_sd(32), lp_w)
    fid_n, fid_b, ppl_n, ppl_b = 1024, 32, 256, 16

    def cli(argv, label, fwd, fir=0):
        rc, s, sh, stdout = counted(lambda: eval_cli.main(argv), label, fwd, fir=fir)
        require(rc == 0, f"{label}: exit {rc}")
        return json.loads(stdout.strip().splitlines()[-1]), s, sh

    for prec in ("exact", "fast"):
        common = ["--device", "cuda", "--precision", prec]
        stats = os.path.join(tmp, f"stats_{prec}.pkl")
        inc, s_inc, _ = cli(["inception", "--path", eval_shards, "--size", "256", "--batch", "64", "--out", stats,
                             "--inception_weights", inc_w, *common], f"(f) inception {prec}", 0)
        fid, s_fid, sh_fid = cli(["fid", "--ckpt", ckpt, "--stats", stats, "--n_sample", str(fid_n), "--batch", str(fid_b),
                                  "--inception_weights", inc_w, *common], f"(f) fid {prec}", N_MLP + (fid_n // fid_b) * per_z,
                                 fir=(fid_n // fid_b) * fir_w)
        require(inc["pretrained"] and inc["n_features"] == 2048, f"(f) inception {inc}")
        require(np.isfinite(fid["fid"]), f"(f) {fid}")
        results[f"f_{prec}"] = dict(inception_images_per_s=512 / s_inc, inception_s=s_inc, fid=fid["fid"],
                                    fid_samples_per_s=fid_n / s_fid, fid_s=s_fid)
        if prec == "exact":  # ppl runs exact only
            ppl, s_ppl, sh_ppl = cli(["ppl", "--ckpt", ckpt, "--n_sample", str(ppl_n), "--batch", str(ppl_b),
                                      "--lpips_weights", lp_w, *common], "(f) ppl exact", (ppl_n // ppl_b) * per_z,
                                     fir=(ppl_n // ppl_b) * fir_w)
            require(np.isfinite(ppl["ppl"]) and ppl["distance"] == "lpips-vgg", f"(f) {ppl}")
            shapes["f_fid"], shapes["f_ppl"] = sh_fid, sh_ppl
            results["f_exact"].update(ppl=ppl["ppl"], ppl_pairs_per_s=ppl_n / s_ppl, ppl_s=s_ppl)
        else:
            try:
                eval_cli.main(["ppl", "--ckpt", ckpt, "--n_sample", str(ppl_n), "--lpips_weights", lp_w, *common])
                refused = False
            except ValueError:
                refused = True
            require(refused, "(f) ppl --precision fast ran")
            results["f_fast"]["ppl_refused"] = refused
        emit(phase="tools_main_path", run="f_eval", precision=prec, **results[f"f_{prec}"])
    results["f_fid_fast_minus_exact"] = results["f_fast"]["fid"] - results["f_exact"]["fid"]
    emit(phase="tools_main_path", run="f_eval_precision", fid_fast_minus_exact=results["f_fid_fast_minus_exact"])

    # (g) the default train CLI (ADA) with --eval_every and SWD, on phase 10's shards
    run = os.path.join(tmp, "run_eval")
    argv = ["--path", ada_shards, "--size", str(TRAIN_SIZE), "--batch_size", str(TRAIN_BATCH), "--iter", "3",
            "--log_every", "1", "--img_every", "0", "--checkpoint_every", "0", "--num_workers", "4", "--device", "cuda",
            "--run_dir", run, "--eval_every", "2", "--eval_metric", "swd", "--swd_n_sample", "48", "--fid_batch", "12"]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        train_loop(build_parser().parse_args(argv))
    wall = time.perf_counter() - t0
    lines = [json.loads(x) for x in open(os.path.join(run, "metrics.jsonl"))]
    evals = [x for x in lines if "SWD" in x]
    per_g = N_MLP + 2 * (int(math.log2(TRAIN_SIZE)) - 2) + 1
    require([x["step"] for x in evals] == [2] and np.isfinite(evals[0]["SWD"]), f"(g) eval lines {evals}")
    require(evals[0]["fused_bias_act launches"] == N_MLP + 4 * per_g,
            f"(g) eval launches {evals[0]['fused_bias_act launches']}, derived {N_MLP + 4 * per_g}")
    require(evals[0]["upfirdn2d launches"] == 4 * fir_per_pass(TRAIN_SIZE),
            f"(g) eval upfirdn2d launches {evals[0]['upfirdn2d launches']}, derived {4 * fir_per_pass(TRAIN_SIZE)}")
    results["g_train_eval"] = dict(steps=3, wall_s=wall, swd=evals[0]["SWD"], eval_s=evals[0]["eval_seconds"],
                                   eval_launches=evals[0]["fused_bias_act launches"])
    emit(phase="tools_main_path", run="g_train_eval", size=TRAIN_SIZE, batch=TRAIN_BATCH, metric="swd", reals=48,
         **results["g_train_eval"])
    results["shapes"] = shapes
    return results


def phase_kernels_tools(shapes: dict) -> None:
    """Both kernels against their plain versions at every launch shape of the
    tools' paths not held before (fp32): the forward kernel for sample, the
    projector, FID and PPL, the gradient kernel for the projector."""
    from collections import Counter

    fwd, grad = Counter(), Counter()
    for f, g in shapes.values():
        fwd.update(f)
        grad.update(g)
    rows = forward_shape_rows(fwd, held_shapes())
    for (shape, dtype), n in sorted(grad.items()):
        rows.append(dict(kernel="fused_bias_act_grad", shape=list(shape), launches=n, **grad_case(shape, torch.float32)))
        torch.cuda.empty_cache()
    emit(phase="kernel_tools", dtype="float32", shapes=rows)


# ---------------------------------------------------------------- phases 15-19: VAE, telemetry, parallel, plugins
VAE_SIZE, VAE_BATCH, VAE_STEPS, VAE_IMAGES = 64, 64, 50, 512
VAE_HIDDEN = (32, 64, 128, 256, 512)  # the reference's accelerate_logcosh widths; latent 512
VAE_FWD_PER_STEP = 2 * len(VAE_HIDDEN)  # 5 encoder + 4 decoder + 1 final ConvBN(fused_lrelu)
VAE_ENC_PER_BATCH = len(VAE_HIDDEN)  # prepare_vae_codes runs the encoder only


def vae_model(seed: int):
    from maua_tpu_torch.models.autoencoder import LogCoshVAE

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return LogCoshVAE(size=VAE_SIZE, latent_dim=512, hidden_dims=VAE_HIDDEN)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the largest |b|."""
    return float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-12)


def phase_vae_card_vs_cpu() -> None:
    """LogCoshVAE at full width (hidden 32-512, latent 512), 64^2, batch 8, in
    training mode from the same weights, images and reparameterisation draw,
    exact fp32 on both: reconstruction, mu, log_var, the loss and the updated
    running statistics within 1e-3 of each tensor's largest value, and one
    step's parameter gradients within 1e-3 of the largest gradient (judged as
    one vector; the worst tensor on its own is reported)."""
    import copy

    from maua_tpu_torch.models.blocks import tf32

    cpu = vae_model(3).train()
    card = copy.deepcopy(cpu).cuda()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(-1, 1, (8, 3, VAE_SIZE, VAE_SIZE)).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((8, 512)).astype(np.float32))
    outs = {}
    for label, m, dev in (("card", card, "cuda"), ("cpu", cpu, "cpu")):
        with tf32(conv=False, matmul=False):
            recon, mu, log_var = m(x.to(dev), eps=eps.to(dev))
            loss = m.loss(x.to(dev), recon, mu, log_var)["Total"]
            grads = torch.autograd.grad(loss, list(m.parameters()))
        outs[label] = dict(fwd=[t.detach().cpu() for t in (recon, mu, log_var, loss.reshape(1))],
                           grads=[g.cpu() for g in grads], buffers=[b.cpu() for b in m.buffers()])
    fwd = {n: rel(a, b) for n, a, b in zip(("recon", "mu", "log_var", "loss"), outs["card"]["fwd"], outs["cpu"]["fwd"])}
    buffers = max(rel(a, b) for a, b in zip(outs["card"]["buffers"], outs["cpu"]["buffers"]))
    grads = rel(torch.cat([g.reshape(-1) for g in outs["card"]["grads"]]), torch.cat([g.reshape(-1) for g in outs["cpu"]["grads"]]))
    names = [n for n, _ in cpu.named_parameters()]
    per_tensor = {n: rel(a, b) for n, a, b in zip(names, outs["card"]["grads"], outs["cpu"]["grads"])}
    worst = max(per_tensor, key=per_tensor.get)
    require(max(fwd.values()) <= 1e-3 and buffers <= 1e-3 and grads <= 1e-3,
            f"VAE card vs CPU: forward {fwd}, running statistics {buffers}, gradients {grads}")
    emit(phase="vae_card_vs_cpu", size=VAE_SIZE, batch=8, hidden_dims=list(VAE_HIDDEN), latent_dim=512,
         rel_err_forward=fwd, rel_err_running_stats=buffers, rel_err_gradients=grads,
         worst_gradient_tensor=worst, worst_gradient_tensor_rel_err=per_tensor[worst], tolerance="1e-3 of the largest value")


def phase_vae_main_path(tmp: str) -> dict:
    """The VAE path at the reference's configuration: 512 synthetic 64^2
    images in raw shards -> `vae_cli --size 64 --batch_size 64` (LogCoshVAE,
    hidden 32-512, latent 512, Adam 1e-3) for 51 steps, saving the weights ->
    `prepare_vae_codes` over the shards with them. The launch counters are set
    to 0 just before each and read just after: 10 forward and 10 gradient
    launches per train step, 5 forward per encoded batch. s/step from the
    trainer's own elapsed times between its logs at steps 0 and 50, and the
    same split into the CLI's host data function alone and train_vae alone
    on a batch already on the card; the loss must fall; the codes of the
    first batch against the CPU's."""
    from maua_tpu_torch.data import RecordShardReader
    from maua_tpu_torch.data.prepare_vae_codes import encode, load_vae
    from maua_tpu_torch.data.prepare_vae_codes import main as codes_main
    from maua_tpu_torch.data.synthetic import write_synth_shards
    from maua_tpu_torch.ops import fused_act
    from maua_tpu_torch.train import vae_cli

    shards, ckpt, codes = (os.path.join(tmp, n) for n in ("vae_shards", "vae.pt", "vae_codes"))
    write_synth_shards(shards, VAE_SIZE, VAE_IMAGES, fmt="raw", seed=51, shard_size=256)
    steps = VAE_STEPS + 1  # the trainer logs every 50 steps from step 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_act.launches = fused_act.grad_launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        fwd_shapes, grad_shapes = record_launch_shapes(lambda: vae_cli.main(
            ["--path", shards, "--size", str(VAE_SIZE), "--batch_size", str(VAE_BATCH), "--iter", str(steps),
             "--device", "cuda", "--save", ckpt]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (fused_act.launches, fused_act.grad_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lines = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
    logs, score = [x for x in lines if "step" in x], lines[-1]
    require(launches == (VAE_FWD_PER_STEP * steps, VAE_FWD_PER_STEP * steps),
            f"vae_cli: launches {launches}, derived {VAE_FWD_PER_STEP} + {VAE_FWD_PER_STEP} per step x {steps}")
    require([x["step"] for x in logs] == [0, VAE_STEPS] and not score["failed"], f"vae_cli lines {lines}")
    require(all(np.isfinite(x["Total"]) for x in logs) and logs[-1]["Total"] < logs[0]["Total"],
            f"vae_cli: the loss did not fall: {[x['Total'] for x in logs]}")
    s_step = (logs[-1]["elapsed"] - logs[0]["elapsed"]) / VAE_STEPS
    per_step = ({k: v // steps for k, v in fwd_shapes.items()}, {k: v // steps for k, v in grad_shapes.items()})
    require(sum(per_step[0].values()) == VAE_FWD_PER_STEP and sum(per_step[1].values()) == VAE_FWD_PER_STEP,
            f"vae launch shapes per step {per_step}")

    torch.cuda.synchronize()
    fused_act.launches = fused_act.grad_launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = codes_main(["--path", shards, "--size", str(VAE_SIZE), "--out", codes, "--batch", str(VAE_BATCH),
                         "--vae_ckpt", ckpt, "--device", "cuda"])
    torch.cuda.synchronize()
    codes_s = time.perf_counter() - t0
    n_batches = -(-VAE_IMAGES // VAE_BATCH)
    require(rc == 0 and (fused_act.launches, fused_act.grad_launches) == (VAE_ENC_PER_BATCH * n_batches, 0),
            f"prepare_vae_codes: launches {(fused_act.launches, fused_act.grad_launches)}, derived "
            f"{VAE_ENC_PER_BATCH} per batch x {n_batches}")
    import pickle

    readers = [RecordShardReader(os.path.join(codes, f)) for f in sorted(os.listdir(codes))]
    got = np.stack([pickle.loads(r.get(i)) for r in readers for i in range(len(r))])
    require(got.shape == (VAE_IMAGES, 512) and got.dtype == np.float32 and np.isfinite(got).all(), f"codes {got.shape}")
    model = load_vae(ckpt, VAE_SIZE, 512, "cpu")
    first = encode(model, shards, VAE_SIZE, VAE_BATCH)[:VAE_BATCH]
    codes_err = rel(torch.from_numpy(got[:VAE_BATCH]), torch.from_numpy(first))
    require(codes_err <= 1e-3, f"codes of the first batch: card vs CPU {codes_err}")
    # where a step's time goes: the CLI's host data function alone, and
    # train_vae alone on one batch already on the card
    import itertools

    from maua_tpu_torch.train.vae import train_vae

    data = vae_cli.make_data_fn(shards, VAE_SIZE, 0, "cuda")(VAE_BATCH)
    next(data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        batch = next(data)
    torch.cuda.synchronize()
    data_s = (time.perf_counter() - t0) / 20
    model = load_vae(ckpt, VAE_SIZE, 512, "cuda")
    train_vae(model, itertools.repeat(batch), n_steps=3, log_every=100)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_vae(model, itertools.repeat(batch), n_steps=20, log_every=100)
    torch.cuda.synchronize()
    step_only_s = (time.perf_counter() - t0) / 20
    del model, batch, data
    result = dict(steps=steps, s_per_step=s_step, images_per_s=VAE_BATCH / s_step, run_wall_s=wall, peak_memory_gb=peak_gb,
                  data_fn_s_per_batch=data_s, step_on_device_batch_s=step_only_s,
                  loss=[x["Total"] for x in logs], score=score["Score"], launches=launches,
                  codes=VAE_IMAGES, codes_per_s=VAE_IMAGES / codes_s, codes_s=codes_s,
                  codes_launches=VAE_ENC_PER_BATCH * n_batches, codes_card_vs_cpu=codes_err)
    emit(phase="vae_main_path", size=VAE_SIZE, batch=VAE_BATCH, hidden_dims=list(VAE_HIDDEN), latent_dim=512, **result,
         launches_per_step=dict(forward=VAE_FWD_PER_STEP, gradient=VAE_FWD_PER_STEP))
    result["shapes"] = per_step
    return result


def phase_kernels_vae(shapes) -> dict:
    """Both kernels against their plain versions at every launch shape of
    one VAE train step (batch 64, 64^2: BatchNorm outputs from 2^2 to 64^2),
    in fp32 and bf16, with time, bound and plain time per shape; per-step
    sums weight each shape by its launches. Returns the fp32 sums."""
    fwd, grad = shapes
    sums = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        tot = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, launches=0)
               for k in ("fused_bias_act", "fused_bias_act_grad")}
        rows = []
        for (shape, _, with_bias), n in sorted(fwd.items()):
            case = bias_act_case(shape, dtype, with_bias)
            rows.append(dict(kernel="fused_bias_act", shape=list(shape), launches_per_step=n, max_abs_err=case["max_abs_err"],
                             ms=case["kernel_ms"], plain_ms=case["plain_ms"], bound_ms=case["bound_ms"],
                             bound_share=case["bound_ms"] / case["kernel_ms"]))
            for k, v in (("ms", case["kernel_ms"]), ("plain_ms", case["plain_ms"]), ("bound_ms", case["bound_ms"])):
                tot["fused_bias_act"][k] += n * v
            tot["fused_bias_act"]["launches"] += n
            tot["fused_bias_act"]["max_abs_err"] = max(tot["fused_bias_act"]["max_abs_err"], case["max_abs_err"])
        for (shape, _), n in sorted(grad.items()):
            case = grad_case(shape, dtype)
            rows.append(dict(kernel="fused_bias_act_grad", shape=list(shape), launches_per_step=n,
                             max_abs_err=case["max_abs_err"], ms=case["kernel_ms"], plain_ms=case["plain_ms"],
                             bound_ms=case["bound_ms"], bound_share=case["bound_ms"] / case["kernel_ms"]))
            for k, v in (("ms", case["kernel_ms"]), ("plain_ms", case["plain_ms"]), ("bound_ms", case["bound_ms"])):
                tot["fused_bias_act_grad"][k] += n * v
            tot["fused_bias_act_grad"]["launches"] += n
            tot["fused_bias_act_grad"]["max_abs_err"] = max(tot["fused_bias_act_grad"]["max_abs_err"], case["max_abs_err"])
        emit(phase="kernel_vae", dtype=name, size=VAE_SIZE, batch=VAE_BATCH, shapes=rows)
        for k, t in tot.items():
            emit(phase="kernel_vae_step", kernel=k, dtype=name, **t)
        sums[name] = tot
    return sums["float32"]


def phase_telemetry(tmp: str, ada_shards: str) -> dict:
    """The default train CLI (256^2, batch 12, ADA with adaptive p, fp32) for
    8 steps without and then with --log_spec_norm --monitor --profile
    --profile_iters 2: s/step by kind of step for each; the trace (trace.json
    and key_averages.txt of the first steps), gpumon.jsonl and the sigma
    summaries on every line.
    Then the monitor thread at a 50 ms interval (a window of 4) and the
    memory helpers on the card."""
    from maua_tpu_torch import telemetry
    from maua_tpu_torch.telemetry.monitor import DeviceMonitor
    from maua_tpu_torch.train.cli import build_parser, train_loop

    results = {}
    for label, extra in (("plain", ()), ("telemetry", ("--log_spec_norm", "--monitor", "--profile", "--profile_iters", "2"))):
        run = os.path.join(tmp, f"run_telemetry_{label}")
        argv = ["--path", ada_shards, "--size", str(TRAIN_SIZE), "--batch_size", str(TRAIN_BATCH), "--iter", str(TRAIN_STEPS),
                "--log_every", "1", "--img_every", "0", "--checkpoint_every", "0", "--num_workers", "4",
                "--device", "cuda", "--run_dir", run, *extra]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            train_loop(build_parser().parse_args(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lines = [json.loads(x) for x in open(os.path.join(run, "metrics.jsonl"))]
        require([x["step"] for x in lines] == list(range(TRAIN_STEPS)), f"telemetry {label}: steps")
        kinds: dict[str, list[float]] = {}
        for x in lines:
            kinds.setdefault("r1_path" if x["step"] == 0 else ("path" if x["step"] % 4 == 0 else "plain"), []).append(x["sec_per_iter"])
        results[label] = dict(wall_s=wall, s_per_step={k: statistics.median(v) for k, v in kinds.items()})
        if label == "telemetry":
            sig = {k: lines[-1][k] for k in lines[-1] if "spectral" in k}
            require(len(sig) == 6 and all(np.isfinite(v) and v > 0 for v in sig.values())
                    and all("G spectral_max" in x for x in lines), f"telemetry: sigma keys {sig}")
            trace = os.path.join(run, "trace")
            with open(os.path.join(trace, "trace.json")) as f:
                traced = f.read()
            require("fused_bias_act_kernel" in traced and '"train_step"' in traced
                    and os.path.getsize(os.path.join(trace, "key_averages.txt")) > 0
                    and os.path.exists(os.path.join(run, "gpumon.jsonl")), f"telemetry: {os.listdir(run)}, {os.listdir(trace)}")
            del traced
            results[label].update(sigmas_last=sig, trace_bytes=os.path.getsize(os.path.join(trace, "trace.json")))
    results["overhead"] = {k: results["telemetry"]["s_per_step"][k] / results["plain"]["s_per_step"][k]
                           for k in results["plain"]["s_per_step"]}

    path = os.path.join(tmp, "gpumon_direct.jsonl")
    mon = DeviceMonitor(path, interval_s=0.05, window=4).start()
    x = torch.zeros(1 << 26, device="cuda")
    t_end = time.time() + 1.0
    while time.time() < t_end:
        x.add_(1.0)
    torch.cuda.synchronize()
    mon.stop()
    mon_lines = [json.loads(line) for line in open(path)]
    require(mon_lines and all(m["dev0_bytes_in_use"] >= x.numel() * 4 and m["host_rss_kb"] > 0 for m in mon_lines),
            f"monitor lines {mon_lines[:2]}")
    snap = telemetry.memory_snapshot()
    telemetry.memory.record_memory_history()
    y = torch.ones(1 << 20, device="cuda") * 2
    dump = os.path.join(tmp, "device_memory.pickle")
    telemetry.save_device_memory_profile(dump)
    torch.cuda.memory._record_memory_history(enabled=None)
    require(snap["bytes_in_use"] >= x.numel() * 4 and os.path.getsize(dump) > 0, "memory snapshot / profile")
    del x, y
    results["monitor"] = dict(lines=len(mon_lines), dev0_bytes_in_use=mon_lines[-1]["dev0_bytes_in_use"],
                              memory_profile_bytes=os.path.getsize(dump))
    emit(phase="telemetry", size=TRAIN_SIZE, batch=TRAIN_BATCH, steps=TRAIN_STEPS, **results)
    return results


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_parallel_on_card(tmp: str, ada_shards: str) -> dict:
    """Data parallel at world size 1 on the one card: the default train CLI
    (256^2, batch 12, ADA, fp32, one loader worker so the records come in
    one order) with `--coordinator 127.0.0.1:<port> --num_processes 1
    --process_id 0` (an NCCL process group: the gradient all-reduce, the
    stddev all-gather and the reductions all run) against the same run
    without a coordinator, in three cases: the default (4 steps);
    `--reg_chunks 3 --d_reg_every 4` (5 steps, R1 and the path penalty in 3
    chunks at steps 0 and 4, so one chunked step runs warm); the contrastive
    regularizer with MoCo and a queue of 48 (4 steps; the queries and keys
    gathered over the group). In each the losses of every step are no
    further from the run without a coordinator than a second run without
    one (cuDNN deterministic; at most 1e-6 apart if both are 0); s/step of
    each, and the overhead of the coordinator on the warm steps. Then one
    bf16 R1 + path step of the flagship configuration at 1024^2 (phase 23)
    under a coordinator: the automatic rule resolves reg_chunks 3 and
    remat_synth there too, and the step's launches equal the structure's.
    Then render(mesh=[cuda:0]) of 16 frames at 1024^2 against render(): the
    same frames within one level (the share of values that differ is
    reported)."""
    import torch.distributed as dist

    from maua_tpu_torch.io import load_generator
    from maua_tpu_torch.parallel import get_mesh
    from maua_tpu_torch.render import render
    from maua_tpu_torch.train.cli import build_parser, train_loop

    def coordinator():
        return ("--coordinator", f"127.0.0.1:{free_port()}", "--num_processes", "1", "--process_id", "0")

    keys = ("Generator", "Discriminator", "R1 Penalty", "Path Length Regularization", "Real Score", "Fake Score")

    def max_rel(a_lines, b_lines):
        return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6) for a, b in zip(a_lines, b_lines) for k in keys)

    cases = {
        "default": (4, (), [1, 2, 3]),
        "reg_chunks_3": (5, ("--reg_chunks", "3", "--d_reg_every", "4"), [4]),
        "contrastive": (4, ("--contrastive", "0.1", "--contrastive_momentum", "0.99", "--contrastive_queue", "48"),
                        [1, 2, 3]),
    }
    result = {}
    # cuDNN's default algorithms may sum a weight gradient in another order
    # from one run to the next, and Adam's first steps turn a gradient
    # element's rounding into a step of +-lr: deterministic algorithms here,
    # and the spread of two runs without a coordinator beside the difference
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for case, (steps, flags, warm_steps) in cases.items():
            runs = {}
            for label, extra in (("single", ()), ("single_again", ()), ("nccl_world_1", coordinator())):
                run = os.path.join(tmp, f"run_dp_{case}_{label}")
                argv = ["--path", ada_shards, "--size", str(TRAIN_SIZE), "--batch_size", str(TRAIN_BATCH), "--iter",
                        str(steps), "--log_every", "1", "--img_every", "0", "--checkpoint_every", "0", "--num_workers",
                        "1", "--device", "cuda", "--run_dir", run, *flags, *extra]
                with contextlib.redirect_stdout(io.StringIO()) as buf:
                    state = train_loop(build_parser().parse_args(argv))
                torch.cuda.synchronize()
                require(not dist.is_initialized(), f"{case} {label}: the process group was left open")
                require(("distributed: process 0/1 on cuda:0" in buf.getvalue()) == (label == "nccl_world_1"),
                        f"{case} {label}: {buf.getvalue()[:200]}")
                runs[label] = [json.loads(x) for x in open(os.path.join(run, "metrics.jsonl"))]
                if case == "contrastive":
                    require(int(state.cl_state.queue_filled) == 48, f"{case} {label}: queue filled "
                            f"{int(state.cl_state.queue_filled)}")
                del state
            diff, spread = max_rel(runs["nccl_world_1"], runs["single"]), max_rel(runs["single_again"], runs["single"])
            require(all(len(v) == steps for v in runs.values()) and diff <= max(spread, 1e-6),
                    f"{case}: DP world 1 vs single: {diff}, two single runs: {spread}")
            if case == "reg_chunks_3":
                require(all(runs["nccl_world_1"][i]["R1 Penalty"] > 0 for i in (0, 4)), f"{case}: R1 at steps 0 and 4")
            s_step = {k: [x["sec_per_iter"] for x in v] for k, v in runs.items()}
            warm = {k: statistics.median([v[i] for i in warm_steps]) for k, v in s_step.items()}
            result[case] = dict(steps=steps, flags=list(flags), loss_rel_diff=diff, single_runs_rel_spread=spread,
                                s_per_step=s_step, warm_steps=warm_steps,
                                dp_overhead_warm=warm["nccl_world_1"] / warm["single"])
            emit(phase="parallel_on_card", case=case, size=TRAIN_SIZE, batch=TRAIN_BATCH, world_size=1, backend="nccl",
                 cudnn_deterministic=True, **result[case])
    finally:
        torch.backends.cudnn.deterministic = deterministic

    # the flagship configuration's R1 + path step under a coordinator
    argv = flagship_argv(flagship_shards(tmp), os.path.join(tmp, "run_1024_dp"), 1, "--bf16")
    cfg = resolved_config(argv + list(coordinator()))  # a fresh port for each process group
    require_flagship(cfg, True)
    r = counted_train_run(argv + list(coordinator()), cfg, 1, "1024 bf16 under a coordinator")
    require(not dist.is_initialized(), "1024: the process group was left open")
    shutil.rmtree(os.path.join(tmp, "run_1024_dp"))
    result["flagship_1024_bf16"] = dict(reg_chunks=cfg.reg_chunks, remat_synth=cfg.remat_synth, launches=r["launches"],
                                        s_per_step=r["s_step"], peak_gb=r["peak_gb"])
    emit(phase="parallel_on_card", case="flagship_1024_bf16", size=FLAG_SIZE, batch=TRAIN_BATCH, world_size=1,
         backend="nccl", steps=1, note="the first step of the process at this size (cold)", **result["flagship_1024_bf16"])
    del r
    torch.cuda.empty_cache()

    gen = load_generator(os.path.join(tmp, "g1024.pt"), device="cuda")
    rng = np.random.default_rng(61)
    with torch.inference_mode():
        latents = gen.map_latents(torch.from_numpy(rng.standard_normal((16, STYLE_DIM), dtype=np.float32)).cuda())
    noise = noise_list(gen, 16, rng, max_width=256)
    frames = {}
    for label, mesh in (("plain", None), ("mesh", get_mesh(["cuda:0"]))):
        frames[label] = []
        with capture_frames(frames[label]):
            t0 = time.perf_counter()
            render(gen, None, latents, noise, os.path.join(tmp, f"mesh_{label}.mp4"), batch_size=8, fps=24, mesh=mesh)
            frames[label + "_s"] = time.perf_counter() - t0
    frame_diff = max(int(np.abs(a.astype(np.int16) - b).max()) for a, b in zip(frames["mesh"], frames["plain"]))
    frame_diff_share = float(np.mean([np.mean(a != b) for a, b in zip(frames["mesh"], frames["plain"])]))
    # one device: the same code path; cuDNN may pick another algorithm from one call to the next
    require(len(frames["mesh"]) == 16 and frame_diff <= 1, f"render(mesh=[cuda:0]) frames {frame_diff} levels off render()'s")
    del gen
    torch.cuda.empty_cache()
    result["mesh_render"] = dict(frames=16, frame_max_diff=frame_diff, frame_diff_share=frame_diff_share,
                                 render_s=frames["plain_s"], mesh_render_s=frames["mesh_s"])
    emit(phase="parallel_on_card", case="mesh_render", size=GEN_SIZE, **result["mesh_render"])
    return result


def phase_plugins(tmp: str) -> dict:
    """generate() with the temper and the rewrite_demo example plugins at
    1024^2 for 2 s of the phase-12 track (60 frames, batch 8): frames/s end
    to end and the launches, set to 0 just before and read just after: 8
    (generate_latents) + 17 per render batch of the forward kernel, 16 per
    render batch of upfirdn2d."""
    from maua_tpu_torch import examples
    from maua_tpu_torch.ops import fused_act
    from maua_tpu_torch.pipeline import generate
    from maua_tpu_torch.pipeline.cli import load_plugin

    fir = fir_module()
    ckpt, wav = os.path.join(tmp, f"g{GEN_SIZE}.pt"), os.path.join(tmp, "track.wav")
    per_batch = 2 * (int(math.log2(GEN_SIZE)) - 2) + 1
    CountingWriter = install_counting_writer()
    results = {}
    for name in ("temper", "rewrite_demo"):
        funcs, override = load_plugin(os.path.join(os.path.dirname(examples.__file__), f"{name}.py"))
        n_frames, batch = 60, 8
        expected = N_MLP + per_batch * (-(-n_frames // batch))
        fir_expected = fir_per_pass(GEN_SIZE) * (-(-n_frames // batch))
        CountingWriter.written = []
        torch.cuda.synchronize()
        fused_act.launches = fused_act.grad_launches = fir.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            generate(ckpt, wav, offset=60.0, duration=2.0, fps=30, batch=batch,
                     output_file=os.path.join(tmp, f"plugin_{name}.mp4"), device="cuda",
                     **{"out_size": GEN_SIZE, **funcs, **override})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = (fused_act.launches, fused_act.grad_launches, fir.launches)
        require(got == (expected, 0, fir_expected), f"{name}: launches {got}, derived ({expected}, 0, {fir_expected})")
        require(len(CountingWriter.written) == n_frames and min(CountingWriter.written) > 0, f"{name}: frames written")
        results[name] = dict(frames=n_frames, wall_s=wall, frames_per_s=n_frames / wall, launches=expected)
        emit(phase="plugins", plugin=name, size=GEN_SIZE, batch=batch, **results[name])
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------- phases 20-22: lucidrains, tensor parallelism
LUC_STEPS = 33  # steps 0, 4, ... 32 take the gradient penalty, steps 0 and 32 the path penalty


def luc_state_on(cfg, device: str, like=None):
    """A lucidrains train state on `device`; with `like`, its whole state
    (weights, EMA copies, optimizer moments, pl_mean, step) copied over."""
    from maua_tpu_torch.train import init_lucidrains_state

    st = init_lucidrains_state(cfg, seed=5, device=device)
    if like is not None:
        st.load_state_dict(like.state_dict())
    return st


def phase_lucidrains_card_vs_cpu() -> dict:
    """The lucidrains family, card against CPU in exact fp32: a narrow model
    (32^2, capacity 4, attention and fq at layer 1, batch 4, the Rezero gains
    set to 0.5) with the same weights and draws. G's and D's forwards within
    1e-4 of the largest value; three steps (ema_start 0, ema_every 1): step 0
    with the gradient and path penalties, step 1 the EMA, step 2 the reset.
    Per step: the metrics within rtol 1e-3, each network's gradients (as its
    DiffGrad keeps them) within 1e-3 of the largest as one vector, its
    weights within 1e-5 where the gradient is above 1e-3 of its tensor's
    largest (DiffGrad steps a near-zero gradient by about lr / 2 either way),
    the EMA copies within lr + 1e-5."""
    from maua_tpu_torch.models.lucidrains import LinearAttention, StyleDraw
    from maua_tpu_torch.train import LucidrainsConfig, make_lucidrains_train_step
    from maua_tpu_torch.train.lucidrains_trainer import draw_lucidrains_step

    cfg = LucidrainsConfig(image_size=32, latent_dim=64, style_depth=4, network_capacity=4, batch_size=4,
                           attn_layers=(1,), fq_layers=(1,), ema_start=0, ema_every=1)
    cpu = luc_state_on(cfg, "cpu")
    with torch.no_grad():
        for net in (cpu.g, cpu.d):
            for m in net.modules():
                if isinstance(m, LinearAttention):
                    m.rezero_g.fill_(0.5)
    card = luc_state_on(cfg, "cuda", like=cpu)
    rng = np.random.default_rng(20)
    n_layers = cpu.g.num_layers
    styles = torch.from_numpy(rng.standard_normal((4, n_layers, 64), dtype=np.float32))
    noise = torch.from_numpy(rng.uniform(size=(4, 32, 32, 1)).astype(np.float32))
    real = torch.from_numpy(rng.uniform(-1, 1, (1, 4, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        fwd = dict(G=rel(card.g(styles.cuda(), noise.cuda()).cpu(), cpu.g(styles, noise)),
                   D=rel(card.d(real[0].cuda())[0].cpu(), cpu.d(real[0])[0]),
                   D_quantize=rel(card.d(real[0].cuda())[1].cpu(), cpu.d(real[0])[1]))
    require(max(fwd.values()) <= 1e-4, f"lucidrains forwards card vs CPU {fwd}")
    step_fn = make_lucidrains_train_step(cfg)
    steps = []
    for step in range(3):
        draws = draw_lucidrains_step(cfg, step, torch.Generator().manual_seed(30 + step), "cpu")
        m_cpu = step_fn(cpu, real, draws)
        m_card = step_fn(card, real.cuda(), to(draws, "cuda"))
        metrics = {k: abs(float(m_card[k]) - float(m_cpu[k])) / max(abs(float(m_cpu[k])), 1e-6) for k in m_cpu}
        grads, weights, emas = {}, {}, {}
        for net, opt in (("s", "g_opt"), ("g", "g_opt"), ("d", "d_opt")):
            pc, pg = list(getattr(cpu, net).parameters()), list(getattr(card, net).parameters())
            gc = [getattr(cpu, opt).state[p]["prev_grad"] for p in pc]
            gg = [getattr(card, opt).state[p]["prev_grad"].cpu() for p in pg]
            grads[net] = rel(torch.cat([g.reshape(-1) for g in gg]), torch.cat([g.reshape(-1) for g in gc]))
            worst = 0.0
            for a, b, g in zip(pg, pc, gc):
                mask = g.abs() > 1e-3 * g.abs().max()
                if mask.any():
                    worst = max(worst, float((a.detach().cpu() - b.detach())[mask].abs().max()) / max(float(b.detach().abs().max()), 1.0))
            weights[net] = worst
        for net in ("se", "ge"):
            emas[net] = max(float((a.cpu() - b).abs().max()) for a, b in zip(getattr(card, net).parameters(), getattr(cpu, net).parameters()))
        steps.append(dict(step=step, metrics_rel=metrics, gradients_rel=grads, weights_masked_rel=weights, ema_abs=emas,
                          R1=float(m_cpu["R1"]), path_length=float(m_cpu["Path Length"])))
        require(max(metrics.values()) <= 1e-3 and max(grads.values()) <= 1e-3 and max(weights.values()) <= 1e-5
                and max(emas.values()) <= cfg.lr + 1e-5, f"lucidrains step {step} card vs CPU: {steps[-1]}")
    require(steps[0]["R1"] > 0 and steps[0]["path_length"] > 0 and steps[1]["R1"] == 0, "the lazy phases of steps 0 and 1")
    emit(phase="lucidrains_card_vs_cpu", size=32, capacity=4, batch=4, forward_rel=fwd, steps=steps,
         tolerance="forwards 1e-4 of the largest; metrics rtol 1e-3; gradients 1e-3 per network; weights 1e-5 where |g| > 1e-3 max")
    return dict(forward=fwd, steps=steps)


def real_pool(n: int, size: int, seed: int) -> torch.Tensor:
    """n smooth synthetic RGB images [n, 3, size, size] in [-1, 1] on the card."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, size, dtype=np.float32), np.linspace(0, 1, size, dtype=np.float32), indexing="ij")
    f = rng.uniform(1, 6, (n, 3, 2)).astype(np.float32)
    ph = rng.uniform(0, 2 * np.pi, (n, 3)).astype(np.float32)
    img = np.sin(2 * np.pi * (f[..., 0, None, None] * yy + f[..., 1, None, None] * xx) + ph[..., None, None])
    return torch.from_numpy(img.astype(np.float32)).cuda()


def phase_lucidrains_main_path(tmp: str) -> dict:
    """LucidrainsTrainer at the JAX config's full width (128^2, latent 512,
    style depth 8, capacity 16, batch 4; lr 2e-4, GP every 4, PL every 32)
    for 33 steps with the defaults and again with attention and fq at layer
    1, on a pool of 132 synthetic images on the card. The launch counters are
    set to 0 just before each run and read just after: this family runs
    neither kernel (plain leaky ReLUs), so both must stay 0. s/step by kind
    of step, images/s over steps 1-32, peak memory, finite losses (train()
    raises otherwise); then a save / load round trip into a new trainer
    (equal state) and generate(n=8, trunc_psi=0.6)."""
    from maua_tpu_torch.ops import fused_act
    from maua_tpu_torch.train import LucidrainsConfig, LucidrainsTrainer

    fir = fir_module()
    pool = real_pool(LUC_STEPS * 4, 128, seed=21)
    results = {}
    for label, over in (("default", {}), ("attn_fq", dict(attn_layers=(1,), fq_layers=(1,)))):
        cfg = LucidrainsConfig(**over)
        tr = LucidrainsTrainer(cfg, models_dir=os.path.join(tmp, "lucidrains"), name=label, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_act.launches = fused_act.grad_launches = fir.launches = 0
        times, logs = [], []
        for step in range(LUC_STEPS):
            t0 = time.perf_counter()
            logs.append(tr.train(pool[step * 4:(step + 1) * 4][None]))
            times.append(time.perf_counter() - t0)
        launches = (fused_act.launches, fused_act.grad_launches, fir.launches)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        require(launches == (0, 0, 0), f"lucidrains {label}: the kernels launched {launches} times; the family runs none")
        require(all(math.isfinite(v) for m in logs for v in m.values()), f"lucidrains {label}: a loss is not finite")
        require(logs[0]["R1"] > 0 and logs[4]["R1"] > 0 and logs[1]["R1"] == 0 and logs[32]["Path Length"] > 0
                and logs[1]["Path Length"] == 0, f"lucidrains {label}: the lazy phases")
        kinds: dict = {}
        for step, t in enumerate(times[1:], start=1):
            kinds.setdefault("gp_pl" if step % 32 == 0 else ("gp" if step % 4 == 0 else "plain"), []).append(t)
        path = tr.save(99)
        other = LucidrainsTrainer(cfg, models_dir=os.path.join(tmp, "lucidrains"), name=label, seed=1, device="cuda")
        other.load(99)
        a, b = tr.state.state_dict(), other.state.state_dict()
        flat_a, flat_b = [], []

        def walk(x, y):
            if isinstance(x, torch.Tensor):
                flat_a.append(x)
                flat_b.append(y)
            elif isinstance(x, dict):
                require(set(x) == set(y), "checkpoint keys")
                for k in x:
                    walk(x[k], y[k])
            else:
                require(x == y, f"checkpoint value {x} != {y}")

        walk(a, b)
        require(all(torch.equal(x, y) for x, y in zip(flat_a, flat_b)), f"lucidrains {label}: load(save()) differs")
        t0 = time.perf_counter()
        imgs = tr.generate(n=8, trunc_psi=0.6)
        gen_s = time.perf_counter() - t0
        require(imgs.shape == (8, 3, 128, 128) and np.isfinite(imgs).all(), f"generate {imgs.shape}")
        results[label] = dict(steps=LUC_STEPS, s_per_step={k: statistics.median(v) for k, v in kinds.items()},
                              step0_s=times[0], images_per_s=4 * (LUC_STEPS - 1) / sum(times[1:]), peak_memory_gb=peak_gb,
                              launches=launches, losses_last=logs[-1], checkpoint_bytes=os.path.getsize(path),
                              checkpoint_tensors=len(flat_a), generate_s=gen_s, generate_std=float(imgs.std()))
        emit(phase="lucidrains_main_path", config=label, size=128, latent_dim=512, style_depth=8, capacity=16, batch=4,
             **results[label])
        del tr, other
        torch.cuda.empty_cache()
    return results


def phase_tp_on_card(tmp: str) -> dict:
    """Tensor-parallel synthesis on the one card: the FFHQ-1024 checkpoint of
    phase 4 under shard_generator_params on a (1, 1) mesh over NCCL at world
    size 1 (the only size one card allows; every StyledConv is sharded, its
    channels gathered over a model group of one). From the same z (batch 8)
    and the stored noise, the frames within 1e-4 of the largest value of the
    unsharded generator's (cuDNN may choose another algorithm between
    calls), and so with noise drawn from one seed. The counters are set to 0 just before the sharded forward and
    read just after: 8 (mapping) + 17 (StyledConvs) forward launches, at
    shapes phase 2 holds. Then the time of a sharded and an unsharded
    forward, in turns (plain, TP, TP, plain), CUDA events."""
    import torch.distributed as dist

    from maua_tpu_torch import parallel
    from maua_tpu_torch.io import load_generator
    from maua_tpu_torch.ops import fused_act

    fir = fir_module()
    gen = load_generator(os.path.join(tmp, f"g{GEN_SIZE}.pt"), device="cuda")
    z = torch.from_numpy(np.random.default_rng(22).standard_normal((8, STYLE_DIM), dtype=np.float32)).cuda()
    parallel.maybe_initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cuda")
    try:
        mesh = parallel.get_2d_mesh(1, 1)
        tp = parallel.shard_generator_params(gen, mesh)
        sharded = sum(1 for p in tp.generator.parameters() if hasattr(p, "to_local"))
        with torch.inference_mode():
            want, _ = gen(z, randomize_noise=False)
            torch.cuda.synchronize()
            fused_act.launches = fused_act.grad_launches = fir.launches = 0
            fwd_shapes, _ = record_launch_shapes(lambda: tp(z, randomize_noise=False))
            launches = (fused_act.launches, fused_act.grad_launches)
            fir_launches = fir.launches
            got, _ = tp(z, randomize_noise=False)
            err = rel(got, want)
            per_batch = 2 * (int(math.log2(GEN_SIZE)) - 2) + 1
            require(launches == (N_MLP + per_batch, 0), f"TP: launches {launches}, derived ({N_MLP} + {per_batch}, 0)")
            require(fir_launches == fir_per_pass(GEN_SIZE),
                    f"TP: upfirdn2d launched {fir_launches} times, derived {fir_per_pass(GEN_SIZE)}")
            require(tuple(got.shape) == (8, 3, GEN_SIZE, GEN_SIZE) and bool(torch.isfinite(got).all()) and err <= 1e-4,
                    f"TP frames: {tuple(got.shape)}, {err} of the largest value off the unsharded generator's")
            require({s for (s, _, _) in fwd_shapes} <= held_shapes(), f"TP launch shapes {sorted(fwd_shapes)}")
            got_r, _ = tp(z, rng=torch.Generator(device="cuda").manual_seed(23))
            want_r, _ = gen(z, rng=torch.Generator(device="cuda").manual_seed(23))
            err_r = rel(got_r, want_r)
            require(err_r <= 1e-4, f"TP frames with drawn noise: {err_r} of the largest value off the unsharded generator's")
            times = {"plain": [], "tp": []}
            for label in ("plain", "tp", "tp", "plain"):
                fn = (lambda: gen(z, randomize_noise=False)) if label == "plain" else (lambda: tp(z, randomize_noise=False))
                times[label].append(cuda_ms(fn, runs=5, warmup=1))
    finally:
        parallel.shutdown_distributed()
    require(not dist.is_initialized(), "TP: the process group was left open")
    ms = {k: statistics.mean(v) for k, v in times.items()}
    result = dict(mesh=[1, 1], world_size=1, backend="nccl", batch=8, sharded_tensors=sharded, frames_rel_err=err,
                  drawn_noise_rel_err=err_r, launches=launches[0], expected_launches=N_MLP + per_batch,
                  upfirdn2d_launches=fir_launches, plain_ms=ms["plain"], tp_ms=ms["tp"],
                  tp_over_plain=ms["tp"] / ms["plain"], runs_ms=times)
    emit(phase="tp_on_card", size=GEN_SIZE, **result)
    del gen, tp
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------- phase 23: the flagship training configuration
FLAG_SIZE, FLAG_RECORDS = 1024, 24
FLAG_STEPS = {"bf16": 4, "fp32_exact": 2}


def flagship_shards(tmp: str) -> str:
    """Synthetic raw shards at 1024^2 (FLAG_RECORDS records from a seed),
    written by the first phase that asks."""
    from maua_tpu_torch.data.synthetic import write_synth_shards

    shards = os.path.join(tmp, "shards_1024")
    if not os.path.isdir(shards):
        t0 = time.perf_counter()
        write_synth_shards(shards, FLAG_SIZE, FLAG_RECORDS, fmt="raw", seed=23)
        emit(phase="train_1024_data", size=FLAG_SIZE, records=FLAG_RECORDS, seconds=time.perf_counter() - t0)
    return shards


def flagship_argv(shards: str, run: str, iters: int, *extra) -> list:
    """The train CLI's default configuration at --size 1024 --batch_size 12."""
    return ["--path", shards, "--size", str(FLAG_SIZE), "--batch_size", str(TRAIN_BATCH), "--iter", str(iters),
            "--log_every", "1", "--img_every", "0", "--checkpoint_every", "0", "--num_workers", "4",
            "--device", "cuda", "--run_dir", run, *extra]


def resolved_config(argv: list):
    """The TrainConfig the train CLI resolves from argv (--print_config)."""
    from maua_tpu_torch.train import TrainConfig
    from maua_tpu_torch.train.cli import build_parser, train_loop

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_loop(build_parser().parse_args(argv + ["--print_config"]))
    return TrainConfig(**json.loads(buf.getvalue().strip().splitlines()[-1]))


def require_flagship(cfg, bf16: bool, reg_chunks: int = 3, remat: bool = True) -> None:
    want = dict(size=FLAG_SIZE, batch_size=TRAIN_BATCH, channel_multiplier=CHANNEL_MULTIPLIER, channel_max=512,
                constant_input=True, augment=True, augment_p=0.0, ada_warp_method="fft", ada_fast_warp=True,
                lookahead=True, bf16=bf16, reg_chunks=reg_chunks, remat_synth=remat)
    got = {k: getattr(cfg, k) for k in want}
    require(got == want, f"the train CLI resolves {got}, the flagship configuration is {want}")


def counted_train_run(argv: list, cfg, iters: int, label: str) -> dict:
    """train_loop(argv) with the four counters set to 0 just before and read
    just after, and the peak memory reset: every step's launches against
    expected_launches(cfg, step) and expected_fir_launches(cfg, step), the
    run's conv double backwards against expected_second_order, finite
    losses, s/step by kind."""
    from maua_tpu_torch.ops import conv, fused_act
    from maua_tpu_torch.train.cli import build_parser, train_loop

    fir = fir_module()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_act.launches = fused_act.grad_launches = fir.launches = conv.second_order = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        state = train_loop(build_parser().parse_args(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, fir_launches = (fused_act.launches, fused_act.grad_launches), fir.launches
    run = argv[argv.index("--run_dir") + 1]
    lines = [json.loads(x) for x in open(os.path.join(run, "metrics.jsonl"))]
    require([x["step"] for x in lines] == list(range(iters)), f"{label}: logged steps {[x['step'] for x in lines]}")
    kinds: dict[str, list[float]] = {}
    for x in lines:
        for k in ("Generator", "Discriminator", "R1 Penalty", "Path Length Regularization", "Mean Path Length",
                  "Augment", "Rt"):
            require(np.isfinite(x[k]), f"{label} step {x['step']}: {k} = {x[k]}")
        want = expected_launches(cfg, x["step"])
        got = (x["fused_bias_act launches"], x["fused_bias_act_grad launches"])
        require(got == want, f"{label} step {x['step']}: launches {got}, derived from the model {want}")
        fir_want = expected_fir_launches(cfg, x["step"])
        require(x["upfirdn2d launches"] == fir_want,
                f"{label} step {x['step']}: upfirdn2d launches {x['upfirdn2d launches']}, derived from the model {fir_want}")
        kinds.setdefault(step_kind(cfg, x["step"]), []).append(x["sec_per_iter"])
    total = tuple(sum(expected_launches(cfg, i)[j] for i in range(iters)) for j in (0, 1))
    require(launches == total, f"{label}: {launches} launches in the run, derived {total}")
    fir_total = sum(expected_fir_launches(cfg, i) for i in range(iters))
    require(fir_launches == fir_total, f"{label}: {fir_launches} upfirdn2d launches in the run, derived {fir_total}")
    second_order = sum(expected_second_order(cfg, i) for i in range(iters))
    require(conv.second_order == second_order,
            f"{label}: {conv.second_order} conv double backwards in the run, derived {second_order}")
    require(lines[0]["R1 Penalty"] > 0 and lines[0]["Path Length Regularization"] > 0, f"{label}: step 0 regularizers")
    return dict(state=state, lines=lines, launches=launches, fir_launches=fir_launches, second_order=second_order,
                wall_s=wall, s_step={k: statistics.median(v) for k, v in kinds.items()},
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def phase_train_1024_main_path(tmp: str) -> dict:
    """The JAX package's flagship training configuration at full width: the
    train CLI's default at --size 1024 --batch_size 12 (channel multiplier 2,
    channel_max 512, constant input, ADA with adaptive p, `--ada_warp auto`
    = the fft warp and the automatic 1x-grid warp, lookahead) on synthetic
    1024^2 raw shards. --print_config must resolve reg_chunks 3 and
    remat_synth on. bf16 for FLAG_STEPS["bf16"] steps and fp32 exact for
    FLAG_STEPS["fp32_exact"], each after a one-step warm-up (R1 and the path
    penalty, each in 3 chunks, due at step 0); the counters are set to 0
    just before each run and read just after, and every step's launches of
    both kernels equal the structure's count (expected_launches, remat
    included). s/step by kind, images/s, peak memory (the warm-up's one
    R1 + path step, and the run); device ms per phase of an R1 + path step
    and its launch shapes, and in bf16 its top CUDA kernels
    (torch.profiler); the trained g_ema through load_generator. Then
    one bf16 R1 + path step with --reg_chunks 1 --remat_synth 0, for the
    peak memory the automatic rule saves."""
    from maua_tpu_torch.io import load_generator
    from maua_tpu_torch.train import draw_step, latest_checkpoint, make_train_phases, make_train_step
    from maua_tpu_torch.train.cli import build_parser, train_loop
    from maua_tpu_torch.train.step import prepare_reals

    shards = flagship_shards(tmp)
    gen_draws = torch.Generator(device="cuda").manual_seed(31)
    u8 = torch.from_numpy(np.random.default_rng(32).integers(
        0, 256, (1, TRAIN_BATCH, FLAG_SIZE, FLAG_SIZE, 3), dtype=np.uint8)).cuda()
    results, shapes = {}, {}
    for label, steps in FLAG_STEPS.items():
        bf16 = label == "bf16"
        extra = ("--bf16",) if bf16 else ()
        cfg = resolved_config(flagship_argv(shards, os.path.join(tmp, f"cfg_1024_{label}"), 1, *extra))
        require_flagship(cfg, bf16)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        warm_run = os.path.join(tmp, f"warm_1024_{label}")
        with contextlib.redirect_stdout(io.StringIO()):  # warm-up: one R1 + path step
            train_loop(build_parser().parse_args(flagship_argv(shards, warm_run, 1, *extra)))
        torch.cuda.synchronize()
        warm = dict(wall_s=time.perf_counter() - t0, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        shutil.rmtree(warm_run)  # a 1024^2 training checkpoint is about a GB
        torch.cuda.empty_cache()

        run = os.path.join(tmp, f"run_1024_{label}")
        r = counted_train_run(flagship_argv(shards, run, steps, *extra), cfg, steps, f"1024 {label}")
        state = r["state"]
        require(set(r["s_step"]) == {"r1_path", "plain"}, f"1024 {label}: step kinds {sorted(r['s_step'])}")

        ckpt = latest_checkpoint(run)
        gen = load_generator(ckpt, device="cuda", dtype=torch.bfloat16 if bf16 else torch.float32)
        z = torch.from_numpy(np.random.default_rng(33).standard_normal((4, STYLE_DIM), dtype=np.float32)).cuda()
        with torch.inference_mode():
            img, _ = gen(z, randomize_noise=False)
        require(tuple(img.shape) == (4, 3, FLAG_SIZE, FLAG_SIZE) and bool(torch.isfinite(img).all()),
                f"1024 {label}: g_ema image {tuple(img.shape)}")
        del gen, img
        shutil.rmtree(run)

        # device ms per phase of an R1 + path step, then its launch shapes
        phases = make_train_phases(cfg)
        real = prepare_reals(u8)
        draws = draw_step(cfg, 0, gen_draws, "cuda")
        with tf32_off():
            phase_ms = {
                "d": cuda_ms(lambda: phases["d"](state, real, draws.d), runs=1, warmup=0),
                "r1": cuda_ms(lambda: phases["r1"](state, real), runs=1, warmup=0),
                "g": cuda_ms(lambda: phases["g"](state, draws.g), runs=1, warmup=0),
                "path": cuda_ms(lambda: phases["path"](state, draws.path), runs=1, warmup=0),
                "tail": cuda_ms(lambda: phases["tail"](state), runs=1, warmup=0),
            }
        del real, draws
        step_fn = make_train_step(cfg)
        state.step = 16 * 10
        shapes[label] = record_launch_shapes(lambda: step_fn(state, u8, draw_step(cfg, state.step, gen_draws, "cuda")))
        profile = (profile_train_step(step_fn, state, u8, cfg, gen_draws, "1024_bf16", 16 * 11, size=FLAG_SIZE)
                   if bf16 else None)
        per_kind = launches_per_kind(cfg, (("r1_path", 0), ("plain", 1)))
        results[label] = dict(steps=steps, launches=r["launches"], fir_launches=r["fir_launches"], s_step=r["s_step"],
                              wall_s=r["wall_s"], peak_gb=r["peak_gb"], warm_up=warm, phase_ms=phase_ms, profile=profile)
        emit(phase="train_1024_main_path", config=label, size=FLAG_SIZE, batch=TRAIN_BATCH,
             channel_multiplier=CHANNEL_MULTIPLIER, channel_max=512, reg_chunks=cfg.reg_chunks,
             remat_synth=cfg.remat_synth, ada_warp=cfg.ada_warp_method, ada_fast_warp=cfg.ada_fast_warp, steps=steps,
             launches=dict(zip(("forward", "gradient"), r["launches"]), upfirdn2d=r["fir_launches"]),
             launches_per_step_kind=per_kind, conv_second_order=r["second_order"],
             s_per_step=r["s_step"], imgs_per_s={k: TRAIN_BATCH / v for k, v in r["s_step"].items()},
             run_wall_s=r["wall_s"], peak_memory_gb=r["peak_gb"], warm_up_r1_path_step=warm,
             phase_device_ms=phase_ms, losses={k: [x[k] for x in r["lines"]] for k in ("Generator", "Discriminator")},
             checkpoint=os.path.basename(ckpt))
        del r, state, phases, step_fn
        torch.cuda.empty_cache()

    # the automatic rule off: one bf16 R1 + path step, unchunked and without remat
    extra = ("--bf16", "--reg_chunks", "1", "--remat_synth", "0")
    cfg = resolved_config(flagship_argv(shards, os.path.join(tmp, "cfg_1024_norule"), 1, *extra))
    require_flagship(cfg, True, reg_chunks=1, remat=False)
    run = os.path.join(tmp, "run_1024_norule")
    r = counted_train_run(flagship_argv(shards, run, 1, *extra), cfg, 1, "1024 bf16 without the rule")
    shutil.rmtree(run, ignore_errors=True)
    results["bf16_no_rule"] = dict(launches=r["launches"], s_step=r["s_step"], peak_gb=r["peak_gb"])
    emit(phase="train_1024_main_path", config="bf16", reg_chunks=1, remat_synth=False, steps=1,
         launches=dict(zip(("forward", "gradient"), r["launches"])), s_per_step=r["s_step"], peak_memory_gb=r["peak_gb"],
         peak_memory_gb_with_rule=results["bf16"]["warm_up"]["peak_gb"],
         note="one R1 + path step each: peak of the warm-up step with reg_chunks 3 + remat against this one")
    del r
    torch.cuda.empty_cache()
    return {"results": results, "shapes": shapes}


def phase_kernels_train(shapes: dict, size: int, held: frozenset = frozenset()) -> dict:
    """Both kernels against their plain versions at every launch shape of one
    R1 + path train step at `size` (recorded on a main path), each in its
    step's dtype (fp32 and bf16 runs), with time, plain time and bound per
    shape (`held_before` marks a shape an earlier phase held; the gradient
    kernel's rows add aten's leaky_relu_backward as a near yardstick);
    per-step sums weight each shape by its launches."""
    per_step = {}
    for label, (fwd, grad) in shapes.items():
        tot = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, launches=0)
               for k in ("fused_bias_act", "fused_bias_act_grad")}
        tot["fused_bias_act_grad"]["leaky_relu_backward_ms"] = 0.0
        rows = []
        cases = [("fused_bias_act", (shape, dtype), n, lambda s=shape, d=dtype, wb=with_bias:
                  bias_act_case(s, getattr(torch, d), wb, eager=False)) for (shape, dtype, with_bias), n in sorted(fwd.items())]
        cases += [("fused_bias_act_grad", (shape, dtype), n, lambda s=shape, d=dtype: grad_case(s, getattr(torch, d)))
                  for (shape, dtype), n in sorted(grad.items())]
        for kernel, (shape, dtype), n, run_case in cases:
            case = run_case()
            row = dict(kernel=kernel, shape=list(shape), dtype=dtype, launches_per_step=n,
                       held_before=(shape, dtype) in held, max_abs_err=case["max_abs_err"], ms=case["kernel_ms"],
                       plain_ms=case["plain_ms"], bound_ms=case["bound_ms"],
                       bound_share=case["bound_ms"] / case["kernel_ms"])
            t = tot[kernel]
            t["max_abs_err"] = max(t["max_abs_err"], case["max_abs_err"])
            for k, v in (("ms", case["kernel_ms"]), ("plain_ms", case["plain_ms"]), ("bound_ms", case["bound_ms"])):
                t[k] += n * v
            if "leaky_relu_backward_ms" in case:
                row["leaky_relu_backward_ms"] = case["leaky_relu_backward_ms"]
                t["leaky_relu_backward_ms"] += n * case["leaky_relu_backward_ms"]
            t["launches"] += n
            rows.append(row)
            torch.cuda.empty_cache()
        emit(phase="kernel_train_shapes", config=label, size=size, batch=TRAIN_BATCH, step_kind="r1_path",
             new_shapes=sum(not r["held_before"] for r in rows), shapes=rows)
        for k, t in tot.items():
            emit(phase="kernel_train_step", kernel=k, config=label, step_kind="r1_path", size=size,
                 batch=TRAIN_BATCH, bound_by="bytes", **t)
        per_step[label] = tot
    return per_step


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

    seconds = {}

    def run(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    per_batch = run("kernels", phase_kernels)
    fir_sums = run("kernels_upfirdn2d", phase_kernels_upfirdn2d)
    run("functions_on_card", phase_functions_on_card)
    with tempfile.TemporaryDirectory() as tmp:
        run("card_vs_cpu", phase_card_vs_cpu, tmp)
        results = run("main_path", phase_main_path, tmp)
        run("train_card_vs_cpu", phase_train_card_vs_cpu)
        train = run("train_main_path", phase_train_main_path, tmp)
        run("augment_card_vs_cpu", phase_augment_card_vs_cpu)
        aug_times = run("augment_times", phase_augment_times)
        run("train_ada_card_vs_cpu", phase_train_ada_card_vs_cpu)
        ada = run("train_ada_main_path", phase_train_ada_main_path, tmp)
        with contextlib.chdir(tmp):  # load_audio's and generate()'s workspace/
            run("generate_card_vs_cpu", phase_generate_card_vs_cpu, tmp)
            gen = run("generate_main_path", phase_generate_main_path, tmp)
            run("tools_card_vs_cpu", phase_tools_card_vs_cpu, tmp)
            tools = run("tools_main_path", phase_tools_main_path, tmp, os.path.join(tmp, "ada_shards"))
            run("vae_card_vs_cpu", phase_vae_card_vs_cpu)
            vae = run("vae_main_path", phase_vae_main_path, tmp)
            run("telemetry", phase_telemetry, tmp, os.path.join(tmp, "ada_shards"))
            run("parallel_on_card", phase_parallel_on_card, tmp, os.path.join(tmp, "ada_shards"))
            run("plugins", phase_plugins, tmp)
            run("lucidrains_card_vs_cpu", phase_lucidrains_card_vs_cpu)
            run("lucidrains_main_path", phase_lucidrains_main_path, tmp)
            run("tp_on_card", phase_tp_on_card, tmp)
            flag = run("train_1024_main_path", phase_train_1024_main_path, tmp)
    # the ADA step's launch shapes are the plain step's (the fused D pass,
    # the same G and D): the kernels are timed once, at those shapes
    require(ada["shapes"] == train["shapes"]["fp32_exact"], "an fp32 ADA step launches the kernels at other shapes")
    per_step = run("kernels_train", phase_kernels_train, train["shapes"], TRAIN_SIZE)
    run("kernels_generate", phase_kernels_generate, gen["shapes"])
    run("kernels_tools", phase_kernels_tools, tools["shapes"])
    step_vae = run("kernels_vae", phase_kernels_vae, vae["shapes"])
    held = {(shape, dtype) for fwd, grad in train["shapes"].values() for (shape, dtype, *_) in [*fwd, *grad]}
    held |= {(shape, dtype) for shape in held_shapes() for dtype in ("float32", "bfloat16")}
    step_1024 = run("kernels_train_1024", phase_kernels_train, flag["shapes"], FLAG_SIZE, frozenset(held))
    for label, dt in (("fp32_exact", "float32"), ("bf16", "bfloat16")):
        prof = ada["profile"][label]
        warp_ms = aug_times[f"fft_{dt}"]["forward_ms"] + aug_times[f"fft_b12_{dt}"]["forward_backward_ms"]
        emit(phase="ada_warp_share", config=label, step_kind="r1_path", warp_ms_per_step=warp_ms,
             unprofiled_step_ms=prof["unprofiled_step_ms"], warp_share=warp_ms / prof["unprofiled_step_ms"],
             cufft_kernels_ms=prof["cufft_kernels_ms"],
             note="warp_ms: fft warp forward on the fused [24] D batch + forward and backward on the [12] G batch")

    emit(phase="kernel_render_batch_fp32", kernel="fused_bias_act", render_launches=results["fp32_exact"]["launches"],
         **{k: per_batch["float32"][k] for k in ("ms", "plain_ms", "bound_ms")})
    # the training path's numbers as the kernels line of earlier slices gave
    # them: launches of the fp32 ADA run (a), sums over one fp32 R1 + path step
    step_fp32 = per_step["fp32_exact"]
    ada_launches = dict(zip(("fused_bias_act", "fused_bias_act_grad"), ada["results"]["a_fp32_exact"]["launches"]))
    emit(phase="kernels_train", rows=[dict(name=k, ada_run_launches=ada_launches[k], **step_fp32[k]) for k in ada_launches])
    # the kernels line: the VAE trainer (vae_cli, 51 steps; times summed over
    # the launches of one fp32 VAE step), and beside it the flagship 1024^2
    # training runs of phase 23 (launches of each run, times summed over one
    # R1 + path step in each precision) and the fp32 ADA run of phase 10
    launches = dict(zip(("fused_bias_act", "fused_bias_act_grad"), vae["launches"]))
    require(min(launches.values()) > 0, f"the VAE path launched a kernel no time: {launches}")
    flag_launches = {label: dict(zip(("fused_bias_act", "fused_bias_act_grad"), flag["results"][label]["launches"]))
                     for label in FLAG_STEPS}
    require(min(n for v in flag_launches.values() for n in v.values()) > 0,
            f"the 1024^2 training runs launched a kernel no time: {flag_launches}")
    rows = []
    for name, replaces in (("fused_bias_act", "maua_tpu/ops/pallas_act.py:38"),
                           ("fused_bias_act_grad", "maua_tpu/ops/pallas_act.py:43")):
        t = step_vae[name]
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
            "ada_run_launches": ada_launches[name],
            "train_1024": {label: dict(run_launches=flag_launches[label][name], steps=FLAG_STEPS[label],
                                       r1_path_step={k: step_1024[label][name][k]
                                                     for k in ("launches", "ms", "plain_ms", "bound_ms")})
                           for label in FLAG_STEPS},
        })
    # upfirdn2d: its launches in phase 4's fp32 render run, times summed over
    # one render batch's 16 sites (fp32); beside them a 256^2 step's sites and
    # the launches of the ADA and flagship training runs
    render_sites = fir_sums["render_1024_b8_float32"]
    require(render_sites["n_sites"] == fir_per_pass(1024), f"render's upfirdn2d sites {render_sites['n_sites']}")
    require(fir_sums["sg1_1024_b8_float32"]["n_sites"] == sg1_fir_per_pass(1024),
            f"StyleGAN1's upfirdn2d sites {fir_sums['sg1_1024_b8_float32']['n_sites']}")
    rows.append({
        "name": "upfirdn2d",
        "route": "cuda",
        "source": "maua_tpu_torch/csrc/upfirdn2d.cu",
        "replaces": None,
        "launches": results["fp32_exact"]["fir_launches"],
        **{k: render_sites[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms")},
        "bound_by": "bytes",
        "library_ms": render_sites["library_ms"],
        "ada_run_launches": ada["results"]["a_fp32_exact"]["fir_launches"],
        "train_256_step_sites": {k: fir_sums["train_256_b12_float32"][k]
                                 for k in ("n_sites", "ms", "plain_ms", "bound_ms", "library_ms")},
        "sg1_1024_b8_sites": {k: fir_sums["sg1_1024_b8_float32"][k]
                              for k in ("n_sites", "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")},
        "train_1024": {label: dict(run_launches=flag["results"][label]["fir_launches"], steps=FLAG_STEPS[label])
                       for label in FLAG_STEPS},
    })
    require(min(rows[-1]["ada_run_launches"], *(v["run_launches"] for v in rows[-1]["train_1024"].values())) > 0,
            f"a training run launched upfirdn2d no time: {rows[-1]}")
    emit(phase="phase_seconds", seconds=seconds, total_s=time.perf_counter() - t0)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

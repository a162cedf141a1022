"""generate(): the audio-reactive music-video API (counterpart of
maua_tpu/pipeline/generate.py).

Load audio -> run the plugin functions (initialize / get_latents / get_noise
/ get_bends / get_rewrites / get_truncation) -> assemble timelines -> load the
generator from a rosinality checkpoint -> `render()` to video. `args` is the
mutable namespace threaded through the plugin functions. With `stylegan1`
the checkpoint is a G_style state dict: `latent_count` z from `Draws(seed)`
go through its mapping network and `StyleGAN1` renders.

Everything runs on `device` (default `cuda`; RuntimeError without a card):
the audio goes there as an fp32 tensor, the audio package's default device
and smoothing factor are set for the plugins, and the analysis runs with TF32
off. Host-only stages (WAV decode, splines, band-pass, beat DP, clustering)
stay numpy/scipy.
"""

from __future__ import annotations

import argparse
import os
import time
import uuid
from typing import Callable, Optional

import numpy as np
import torch

from .. import audio as ar
from ..device import DeviceLike, resolve_device
from ..draws import Draws
from ..io.torch_ckpt import infer_generator_config, load_generator, load_torch_checkpoint
from ..models.blocks import tf32
from ..models.stylegan1 import load_stylegan1
from ..reactive import generate_latents, load_latents, save_latents
from ..render import render


def get_noise_range(out_size: int, generator_resolution: int, is_stylegan1: bool = False):
    """Noise-scale geometry for SG1 vs SG2 layer indexing: (first scale,
    scale past the last, scale -> log2 of the side)."""
    log_max_res = int(np.log2(out_size))
    log_min_res = 2 + (log_max_res - int(np.log2(generator_resolution)))
    if is_stylegan1:
        return log_min_res, log_max_res + 1, lambda x: x
    return 2 * log_min_res + 1, 2 * (log_max_res + 1), lambda x: int(x / 2)


def load_generator_for_render(
    ckpt: str,
    G_res: int = 1024,
    out_size: int = 1024,
    noconst: bool = False,
    latent_dim: int = 512,
    n_mlp: int = 8,
    channel_multiplier: int = 2,
    base_res_factor: float = 1,
    stylegan1: bool = False,
    device: DeviceLike = None,
):
    """The render generator from a checkpoint, on `device`: the StyleGAN2
    `Generator`, or with `stylegan1` the `StyleGAN1` of a G_style checkpoint
    (its constant widened for out_size 1920)."""
    if stylegan1:
        return load_stylegan1(ckpt, output_size=out_size, device=device)
    return load_generator(
        ckpt,
        output_size=out_size if out_size != G_res else None,
        base_res_factor=base_res_factor,
        device=device,
        size=G_res,
        style_dim=latent_dim,
        n_mlp=n_mlp,
        channel_multiplier=channel_multiplier,
        constant_input=not noconst,
    )


def generate(
    ckpt: str,
    audio_file: str,
    initialize: Optional[Callable] = None,
    get_latents: Optional[Callable] = None,
    get_noise: Optional[Callable] = None,
    get_bends: Optional[Callable] = None,
    get_rewrites: Optional[Callable] = None,
    get_truncation: Optional[Callable] = None,
    output_dir: str = "./output",
    offset: float = 0,
    duration: float = -1,
    latent_file: Optional[str] = None,
    shuffle_latents: bool = False,
    G_res: int = 1024,
    out_size: int = 1024,
    fps: float = 30,
    latent_count: int = 12,
    batch: int = 8,
    truncation: float = 1.0,
    stylegan1: bool = False,
    noconst: bool = False,
    latent_dim: int = 512,
    n_mlp: int = 8,
    channel_multiplier: int = 2,
    randomize_noise: bool = False,
    ffmpeg_preset: str = "slow",
    base_res_factor: float = 1,
    output_file: Optional[str] = None,
    seed: int = 0,
    mesh=None,
    args: Optional[argparse.Namespace] = None,
    device: DeviceLike = None,
) -> str:
    """Render an audio-reactive video; returns the output file path. `mesh`:
    None, or the devices of a frame-parallel render (`parallel.get_mesh`),
    starting with `device`."""
    if args is None:
        args = argparse.Namespace(**{k: v for k, v in locals().items() if k != "args"})
    device = args.device = resolve_device(device)
    if mesh is not None and (not mesh or torch.device(mesh[0]) != device):
        raise ValueError(f"the mesh {mesh} must start with the render device {device}")

    # smoothing independent of frame rate; numpy inputs of the plugins go to `device`
    ar.set_SMF(fps / 30)
    ar.set_device(device)
    t0 = time.time()

    audio, sr, duration = ar.load_audio(audio_file, offset, duration)
    args.audio, args.sr = torch.as_tensor(audio, dtype=torch.float32, device=device), sr
    n_frames = int(round(duration * fps))
    args.duration, args.n_frames = duration, n_frames

    # Reconcile G_res with a StyleGAN2 checkpoint's resolution: a stale
    # --G_res would build the noise-scale geometry for the wrong pyramid. A
    # square out_size that tracked the stale G_res follows it; widescreen
    # targets stay. A StyleGAN1 checkpoint is taken at G_res, as in JAX.
    if not stylegan1:
        sd = load_torch_checkpoint(ckpt)
        true_size = infer_generator_config(sd.get("g_ema", sd))["size"]
        del sd
        if true_size != G_res:
            print(f"G_res={G_res} does not match checkpoint resolution {true_size}; using {true_size}")
            if out_size == G_res:
                print(f"out_size={out_size} tracked the stale G_res; using {true_size}")
                out_size = args.out_size = true_size
            G_res = args.G_res = true_size

    # with no plugin function at all, the default initialize computes the
    # lo/hi onset envelopes the default get_latents/get_noise read
    from . import defaults

    if initialize is None and get_latents is None and get_noise is None:
        initialize = defaults.initialize
    with tf32(conv=False, matmul=False):
        if initialize is not None:
            args = initialize(args)
        # the default latents and noise read the default onset envelopes: a
        # plugin with its own initialize but not those functions (as
        # examples/rewrite_demo.py) gets them too, where the JAX package
        # raises AttributeError
        if (get_latents is None or get_noise is None) and not hasattr(args, "lo_onsets"):
            args = defaults.initialize(args)

        # ---- latents ----
        if get_latents is None:
            get_latents = defaults.get_latents
        if latent_file is not None:
            latent_selection = load_latents(latent_file)
        elif stylegan1:
            # z from Draws(seed) through the StyleGAN1 mapping network
            sg1 = load_stylegan1(ckpt, device=device)
            with torch.inference_mode():
                latent_selection = sg1.map_latents(Draws(seed, device).normal(latent_count, 512))
            del sg1
        else:
            latent_selection = generate_latents(
                latent_count, ckpt, G_res, noconst, latent_dim, n_mlp, channel_multiplier, seed=seed, device=device
            )
        if shuffle_latents:
            perm = np.random.default_rng(seed).permutation(len(latent_selection))
            latent_selection = latent_selection[torch.as_tensor(perm, device=latent_selection.device)]
        os.makedirs("workspace", exist_ok=True)
        save_latents(latent_selection, "workspace/last-latents.npy")

        latents = ar.as_tensor(get_latents(selection=latent_selection, args=args))
        print(f"{list(latents.shape)} amplitude={latents.std(correction=0).item():.4f}")

        # ---- noise ----
        if get_noise is None:
            get_noise = defaults.get_noise
        noise = []
        range_min, range_max, exponent = get_noise_range(out_size, G_res, stylegan1)
        for scale in range(range_min, range_max):
            h = (2 if out_size == 1080 else 1) * 2 ** exponent(scale)
            w = (2 if out_size == 1920 else 1) * 2 ** exponent(scale)
            n = get_noise(height=h, width=w, scale=scale - range_min, num_scales=range_max - range_min, args=args)
            noise.append(None if n is None else ar.as_tensor(n))
            if noise[-1] is not None:
                print(list(noise[-1].shape), f"amplitude={noise[-1].std(correction=0).item():.4f}")

        # ---- bends / rewrites / truncation ----
        bends = get_bends(args=args) if get_bends is not None else []
        rewrites = get_rewrites(args=args) if get_rewrites is not None else []
        if get_truncation is not None:
            truncation_timeline = ar.as_tensor(get_truncation(args=args))
        else:
            truncation_timeline = float(truncation)

    # ---- generator ----
    gen = load_generator_for_render(
        ckpt, G_res, out_size, noconst, latent_dim, n_mlp, channel_multiplier, base_res_factor, stylegan1, device=device
    )
    truncation_latent = None
    if (not isinstance(truncation_timeline, float)) or truncation_timeline != 1.0:
        truncation_latent = gen.mean_latent(torch.Generator(device=device).manual_seed(seed))

    print(f"preprocessing took {time.time() - t0:.2f}s; rendering {n_frames} frames...")

    if output_file is None:
        ckpt_title = os.path.splitext(os.path.basename(ckpt))[0].lower()
        track_title = os.path.splitext(os.path.basename(audio_file))[0].lower()
        os.makedirs(output_dir, exist_ok=True)
        output_file = f"{output_dir}/{track_title}_{ckpt_title}_{uuid.uuid4().hex[:8]}.mp4"

    render(
        generator=gen,
        variables=None,
        latents=latents,
        noise=noise,
        output_file=output_file,
        batch_size=batch,
        duration=duration,
        fps=fps,
        truncation=truncation_timeline,
        truncation_latent=truncation_latent,
        bends=bends,
        rewrites=rewrites,
        randomize_noise=randomize_noise,
        out_size=out_size,
        audio_file=audio_file,
        offset=offset,
        ffmpeg_preset=ffmpeg_preset,
        mesh=mesh,
        device=device,
    )
    print(f"total time taken: {(time.time() - t0) / 60:.2f} minutes")
    return output_file

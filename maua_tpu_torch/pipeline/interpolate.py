"""Latent-interpolation / noise-animation video (counterpart of
maua_tpu/pipeline/interpolate.py).

* latent timelines: spline or slerp loops over sampled latents, the first
  latent held (`static`), or a user .npy (`--latents`);
* the segmented moving-noise timeline: per-scale noise that moves in one band
  of the video and holds still elsewhere, smoothed in time on the device;
* the optional noise-debug video of the moving scales (`<output>_noise.mp4`);
* the manipulation bends: the layer-0 edge pad + fixed noise when out_size
  exceeds the checkpoint's resolution, and translate / zoom / rotate
  timelines on chosen layers.

    python -m maua_tpu_torch.pipeline.interpolate --ckpt g.pt --duration 10 [--device cpu]

Draws: the segmented noise and the manipulations' noise from numpy
`RandomState(seed)` (the same numbers as the JAX package); the latents'
z from `Draws(seed)` (`generate_latents` for StyleGAN2); the mean latent for
truncation from a `torch.Generator` seeded with `seed`.
"""

from __future__ import annotations

import argparse
import math
import os
import uuid
from typing import Optional

import numpy as np
import torch

from ..audio.postprocess import gaussian_filter
from ..device import DeviceLike, resolve_device
from ..draws import Draws
from ..reactive import add_noise_bend, generate_latents, pad_bend, rotate_bend, slerp_loops, spline_loops, translate_bend, zoom_bend
from ..render import render
from .generate import get_noise_range, load_generator_for_render

__all__ = ["build_manipulations", "interpolation_video", "main", "noise_debug_video", "segmented_noise"]


def segmented_noise(
    n_frames: int,
    out_size: int,
    G_res: int,
    stylegan1: bool = False,
    moving_frames: int = 200,
    mid_start: int = 260,
    gains: tuple[float, float, float] = (2.0, 4.0, 8.0),
    max_scale_idx: int = 14,
    smooth: float = 7.0,
    seed: int = 0,
    device: DeviceLike = None,
) -> list:
    """Per noise scale i, a [n_frames, 1, h, w] timeline on `device`:

    * i < 4 (coarse):   [moving(moving_frames) x gains[0], static hold]
    * 4 <= i < 8 (mid): [static(mid_start), moving x gains[1], static]
    * i >= 8 (fine):    [static hold, moving x gains[2]]
    * i > max_scale_idx: None

    `moving` is gaussian_filter(randn, 3); the assembled timeline is smoothed
    again with sigma `smooth`. Shorter videos clip the segments to fit. The
    draws are numpy's RandomState(seed); the filters run on `device`."""
    device = resolve_device(device)
    mv = max(1, min(moving_frames, n_frames // 2))
    lead = min(mid_start, max(0, n_frames - mv) // 2)
    range_min, range_max, exponent = get_noise_range(out_size, G_res, stylegan1)
    rng = np.random.RandomState(seed)
    noise: list = []
    for i, scale in enumerate(range(range_min, range_max)):
        h = (2 if out_size == 1080 else 1) * 2 ** exponent(scale)
        w = (2 if out_size == 1920 else 1) * 2 ** exponent(scale)
        if i > max_scale_idx:
            noise.append(None)
            continue
        base = torch.from_numpy(rng.randn(1, 1, h, w).astype(np.float32)).to(device)
        gain = gains[0] if i < 4 else gains[1] if i < 8 else gains[2]
        moving = gain * gaussian_filter(torch.from_numpy(rng.randn(mv, 1, h, w).astype(np.float32)).to(device), 3)
        if i < 4:
            parts = [moving, base.expand(n_frames - mv, -1, -1, -1)]
        elif i < 8:
            parts = [base.expand(lead, -1, -1, -1), moving, base.expand(n_frames - lead - mv, -1, -1, -1)]
        else:
            parts = [base.expand(n_frames - mv, -1, -1, -1), moving]
        noise.append(gaussian_filter(torch.cat([p for p in parts if len(p)]), smooth))
    return noise


def noise_debug_video(noise: list, output_file: str, fps: float, size: int = 256) -> Optional[str]:
    """Write each moving scale's timeline, bilinearly resized to size^2 and
    normalised to [0, 255] grey, one after another; returns the path, or None
    when no scale moves."""
    import cv2

    from ..render.video import VideoWriter

    segments = []
    for n in noise:
        if n is None or len(n) == 0:
            continue
        n = n.detach().cpu().numpy() if isinstance(n, torch.Tensor) else np.asarray(n)
        if len(n) > 1 and np.ptp(n, axis=0).max() < 1e-6:  # a still scale would pad the video with a freeze
            continue
        segments.append(n[:, 0])
    if not segments:
        return None
    vw = VideoWriter(output_file, size, size, fps)
    try:
        for seg in segments:
            lo, hi = float(seg.min()), float(seg.max())
            scale = 255.0 / max(hi - lo, 1e-8)
            for frame in seg:
                f = cv2.resize(frame, (size, size), interpolation=cv2.INTER_LINEAR)
                f = ((f - lo) * scale).clip(0, 255).astype(np.uint8)
                vw.write(np.repeat(f[:, :, None], 3, axis=2))
    finally:
        vw.close()
    return output_file


def build_manipulations(
    n_frames: int,
    out_size: int,
    G_res: int,
    translate_layer: Optional[int] = None,
    zoom_layer: Optional[int] = None,
    rotate_layer: Optional[int] = None,
    seed: int = 0,
    device: DeviceLike = None,
) -> list:
    """The manipulation bends:

    * out_size > G_res: layer 0 edge-padded from 4x4 up to the enlarged
      minimum resolution and overlaid with fixed 2 * N(0, 1) noise;
    * `translate_layer`: one full-width horizontal scroll over the video;
    * `zoom_layer`: a smoothed rise-and-fall zoom in [0.5, 1.5];
    * `rotate_layer`: one smoothed 0 -> 360 degree turn.
    """
    device = resolve_device(device)
    rng = np.random.RandomState(seed)
    bends = []
    log_min_res = 2 + int(math.log2(out_size)) - int(math.log2(G_res))
    if log_min_res > 2:
        pad = sum(2 ** (lres - 1) for lres in range(2, log_min_res))
        bends.append(pad_bend(0, (pad, pad, pad, pad), mode="edge"))
        side = 2**log_min_res
        bends.append(add_noise_bend(0, torch.from_numpy(2.0 * rng.randn(1, 1, side, side).astype(np.float32)).to(device)))
    if translate_layer is not None:
        bends.append(translate_bend(translate_layer, torch.linspace(0.0, 1.0, n_frames, device=device)))
    if zoom_layer is not None:
        ramp = np.concatenate([
            np.linspace(0.0, 3.0, n_frames // 2, dtype=np.float32),
            np.linspace(3.0, 0.0, n_frames - n_frames // 2, dtype=np.float32) + 1,
        ])
        ramp = gaussian_filter(torch.from_numpy(ramp).to(device), 30.0)
        ramp = ramp - ramp.min()
        ramp = ramp / torch.clamp(ramp.max(), min=1e-8)
        bends.append(zoom_bend(zoom_layer, ramp + 0.5))
    if rotate_layer is not None:
        s = 1.0 / (1.0 + np.exp(-np.linspace(0.0, 1.0, n_frames + 1)))
        s -= s.min()
        s /= max(s.max(), 1e-8)
        bends.append(rotate_bend(rotate_layer, torch.from_numpy((360.0 * s[:-1]).astype(np.float32)).to(device)))
    return bends


def _stylegan1_latents(ckpt: str, n: int, seed: int, device: torch.device) -> torch.Tensor:
    """W+ [n, 18, 512] of z from Draws(seed) through the StyleGAN1 mapping."""
    from ..models.stylegan1 import load_stylegan1

    sg1 = load_stylegan1(ckpt, device=device)
    with torch.inference_mode():
        return sg1.map_latents(Draws(seed, device).normal(n, 512))


def interpolation_video(
    ckpt: str,
    n_latents: int = 8,
    duration: float = 10.0,
    fps: float = 30.0,
    loops: int = 1,
    interp: str = "spline",  # spline | slerp | static
    truncation: float = 1.0,
    smoothing: float = 2.0,
    batch: int = 8,
    out_size: Optional[int] = None,
    output_file: Optional[str] = None,
    seed: int = 0,
    noise_mode: str = "stored",  # stored | segmented
    noise_debug: bool = False,
    latents_file: Optional[str] = None,
    G_res: Optional[int] = None,
    stylegan1: bool = False,
    noconst: bool = False,
    channel_multiplier: int = 2,
    translate_layer: Optional[int] = None,
    zoom_layer: Optional[int] = None,
    rotate_layer: Optional[int] = None,
    device: DeviceLike = None,
) -> str:
    """Render an interpolation video on `device` (default `cuda`); returns
    the output path. A StyleGAN2 checkpoint's resolution comes from the
    checkpoint; a StyleGAN1 one's from G_res (default 1024)."""
    device = resolve_device(device)
    n_frames = int(round(duration * fps))

    if not stylegan1 and G_res is None:
        from ..io.torch_ckpt import infer_generator_config, load_torch_checkpoint

        sd = load_torch_checkpoint(ckpt)
        G_res = infer_generator_config(sd.get("g_ema", sd))["size"]

    if latents_file is not None:
        selection = torch.from_numpy(np.load(latents_file).astype(np.float32)).to(device)
    elif stylegan1:
        selection = _stylegan1_latents(ckpt, n_latents, seed, device)
    else:
        selection = generate_latents(n_latents, ckpt, G_res, noconst, channel_multiplier=channel_multiplier,
                                     seed=seed, device=device)

    if interp == "static":  # hold the first latent; the segmented noise moves
        latents = selection[[0]].repeat(n_frames, 1, 1)
    elif interp == "slerp":
        latents = slerp_loops(selection, n_frames, loops, smoothing=smoothing, n_latent=selection.shape[1])
    else:
        latents = spline_loops(selection, n_frames, loops)

    res = G_res or 1024
    eff_out = out_size or res
    gen = load_generator_for_render(ckpt, res, eff_out, noconst, 512, 8, channel_multiplier, 1, stylegan1, device=device)

    noise: list = []
    if noise_mode == "segmented":
        noise = segmented_noise(n_frames, eff_out, res, stylegan1, seed=seed, device=device)
    bends = build_manipulations(n_frames, eff_out, res, translate_layer, zoom_layer, rotate_layer, seed, device)

    trunc_latent = None
    if truncation != 1.0:
        trunc_latent = gen.mean_latent(torch.Generator(device=device).manual_seed(seed))

    if output_file is None:
        os.makedirs("output", exist_ok=True)
        output_file = f"output/interp_{uuid.uuid4().hex[:8]}.mp4"

    if noise_debug and noise:
        dbg = noise_debug_video(noise, os.path.splitext(output_file)[0] + "_noise.mp4", fps)
        if dbg:
            print(dbg)

    return render(
        generator=gen,
        variables=None,
        latents=latents,
        noise=noise,
        output_file=output_file,
        batch_size=batch,
        fps=fps,
        truncation=float(truncation),
        truncation_latent=trunc_latent,
        bends=bends,
        out_size=out_size,
        device=device,
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="latent interpolation / noise animation video")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--n_latents", type=int, default=8)
    p.add_argument("--duration", type=float, default=10.0)
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--n_frames", type=int, default=None, help="overrides duration * fps")
    p.add_argument("--loops", type=int, default=1)
    p.add_argument("--interp", choices=["spline", "slerp", "static"], default="spline")
    p.add_argument("--truncation", type=float, default=1.0)
    p.add_argument("--smoothing", type=float, default=2.0)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--out_size", type=int, default=None)
    p.add_argument("--output_file", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--G_res", type=int, default=None)
    p.add_argument("--latents", type=str, default=None, help="latent .npy selection")
    p.add_argument("--stylegan1", action="store_true")
    p.add_argument("--const", action="store_true", help="checkpoint uses LatentInput (noconst)")
    p.add_argument("--channel_multiplier", type=int, default=2)
    p.add_argument("--noise_mode", choices=["stored", "segmented"], default="stored",
                   help="segmented = the moving-noise timeline")
    p.add_argument("--noise_debug_video", action="store_true",
                   help="also write <output>_noise.mp4 of the moving noise scales")
    p.add_argument("--translate_layer", type=int, default=None)
    p.add_argument("--zoom_layer", type=int, default=None)
    p.add_argument("--rotate_layer", type=int, default=None)
    p.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    duration = a.n_frames / a.fps if a.n_frames is not None else a.duration
    out = interpolation_video(
        a.ckpt, a.n_latents, duration, a.fps, a.loops, a.interp, a.truncation, a.smoothing, a.batch,
        a.out_size, a.output_file, a.seed, noise_mode=a.noise_mode, noise_debug=a.noise_debug_video,
        latents_file=a.latents, G_res=a.G_res, stylegan1=a.stylegan1, noconst=a.const,
        channel_multiplier=a.channel_multiplier, translate_layer=a.translate_layer, zoom_layer=a.zoom_layer,
        rotate_layer=a.rotate_layer, device=a.device,
    )
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

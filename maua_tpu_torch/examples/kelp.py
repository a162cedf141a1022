"""Loop-based interpolation with structure analysis, in torch for the port
(counterpart of examples/kelp.py): laplacian segmentation picks sections,
looping spline latents run per section, RMS blends intro/drop latent sets,
and the noise is time-looping perlin.

Run:  python -m maua_tpu_torch.pipeline.cli --ckpt g.pt --audio_file track.wav \\
          --audioreactive_file maua_tpu_torch/examples/kelp.py
"""

import torch

import maua_tpu_torch.audio as ar
from maua_tpu_torch.reactive import looping_perlin, spline_loops, wrapping_slice

OVERRIDE = dict(out_size=1024)
BPM = 130


def initialize(args):
    # RMS distinguishes drops from intros/outros
    rms = ar.rms(args.audio, args.sr, args.n_frames, smooth=10, clip=60, power=1)
    rms = ar.expand(rms, threshold=0.8, ratio=10)
    rms = ar.gaussian_filter(rms, 4)
    args.rms = ar.normalize(rms)

    args.kick_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmax=150, smooth=4)
    args.snare_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmin=500, smooth=4)
    return args


def get_latents(selection, args):
    rms = args.rms[:, None, None]
    lo = args.kick_onsets[:, None, None]
    hi = args.snare_onsets[:, None, None]

    # sections via laplacian segmentation
    timestamps, labels = ar.laplacian_segmentation(args.audio, args.sr, k=5)
    sel = ar.as_tensor(selection, device=rms.device)
    intro_sel = sel[: len(sel) // 2]
    drop_sel = sel[len(sel) // 2 :]

    # per-section looping latents, one bar per loop
    latents = torch.zeros((args.n_frames,) + tuple(sel.shape[1:]), device=sel.device)
    for (start, stop), label in zip(zip(timestamps, list(timestamps[1:]) + [args.duration]), labels):
        start_f = int(round(start / args.duration * args.n_frames))
        stop_f = int(round(stop / args.duration * args.n_frames))
        if stop_f <= start_f:
            continue
        section_frames = stop_f - start_f
        bars = max(1.0, (stop - start) * (BPM / 60) / 4)
        source = intro_sel if label % 2 == 0 else drop_sel
        loops = spline_loops(wrapping_slice(source, label, 4), section_frames, max(1, int(bars // 4)))
        latents[start_f:stop_f] = loops[:section_frames]

    # RMS blends toward the drop set
    latents = rms * drop_sel.mean(0, keepdim=True) + (1 - rms) * latents
    latents = hi * sel[-4][None] + (1 - hi) * latents
    latents = lo * sel[-7][None] + (1 - lo) * latents
    return ar.gaussian_filter(latents, 3)


def get_noise(height, width, scale, num_scales, args):
    if width > 512:
        return None
    # looping perlin modulated by RMS
    device = args.rms.device
    perlin = looping_perlin(torch.Generator(device=device).manual_seed(width), args.n_frames, height, width, periods=4)
    rng = torch.Generator(device=device).manual_seed(hash((height, width, 1)) % 2**31)
    noisy = ar.gaussian_filter(torch.randn((args.n_frames, 1, height, width), generator=rng, device=device), 5)
    rms = args.rms[:, None, None, None]
    noise = rms * noisy + (1 - rms) * perlin
    return noise / (torch.std(noise, correction=0) * 2)

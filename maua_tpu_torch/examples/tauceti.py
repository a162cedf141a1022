"""Network bending example, in torch for the port (counterpart of
examples/tauceti.py): an edge pad + noise bend on the constant layer, which
makes the 4x4 constant 4x8 for 2:1 widescreen output, and a saw-tooth
scrolling translate bend on layer 4 during the drop.

Run:  python -m maua_tpu_torch.pipeline.cli --ckpt g.pt --audio_file track.wav \\
          --audioreactive_file maua_tpu_torch/examples/tauceti.py
"""

import numpy as np
import torch

import maua_tpu_torch.audio as ar
from maua_tpu_torch.reactive import add_noise_bend, chroma_weight_latents, pad_bend, translate_bend

OVERRIDE = dict(out_size=1920)


def initialize(args):
    args.low_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmax=150, smooth=5, clip=97, power=2)
    args.high_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmin=500, smooth=5, clip=99, power=2)
    return args


def get_latents(selection, args):
    chroma = ar.chroma(args.audio, args.sr, args.n_frames)
    sel = ar.as_tensor(selection, device=chroma.device)
    latents = ar.gaussian_filter(chroma_weight_latents(chroma, sel[: chroma.shape[1]]), 4)
    lo = args.low_onsets[:, None, None]
    hi = args.high_onsets[:, None, None]
    latents = hi * sel[-4][None] + (1 - hi) * latents
    latents = lo * sel[-7][None] + (1 - lo) * latents
    return ar.gaussian_filter(latents, 2, causal=0.2)


def get_noise(height, width, scale, num_scales, args):
    if width > 256:
        return None
    lo = 1.25 * args.low_onsets[:, None, None, None]
    hi = 1.25 * args.high_onsets[:, None, None, None]
    device = args.low_onsets.device
    rng = torch.Generator(device=device).manual_seed(hash((height, width)) % 2**31)
    shape = (args.n_frames, 1, height, width)
    noise_noisy = ar.gaussian_filter(torch.randn(shape, generator=rng, device=device), 5)
    noise = ar.gaussian_filter(torch.randn(shape, generator=rng, device=device), 128)
    if width > 8:
        noise = lo * noise_noisy + (1 - lo) * noise
        noise = hi * noise_noisy + (1 - hi) * noise
    return noise / (torch.std(noise, correction=0) * 2.5)


def get_bends(args):
    # widen the constant layer to 2:1 and add variation noise
    device = args.audio.device
    rng = torch.Generator(device=device).manual_seed(0)
    bends = [
        pad_bend(0, (2, 2, 0, 0)),
        add_noise_bend(0, 0.025 * torch.randn((1, 1, 4, 8), generator=rng, device=device)),
    ]

    # scrolling drop (45 s to 135 s, clamped to the track): saw-tooth
    # translation in [0, 1] scroll fractions of the layer width
    fps = args.fps
    drop_start = min(int(args.n_frames * (45 / max(args.duration, 1))), args.n_frames)
    drop_end = min(int(args.n_frames * (135 / max(args.duration, 1))), args.n_frames)

    loop_len = max(2, int(6 * fps))
    n_loops = max(0, (drop_end - drop_start) // loop_len)
    trunc = (drop_end - drop_start) - n_loops * loop_len

    ramp = np.linspace(0, 1, loop_len)
    x = np.concatenate(
        [
            np.zeros(drop_start),
            np.concatenate([ramp] * n_loops) if n_loops else np.zeros(0),
            ramp[:trunc],
            np.full(args.n_frames - drop_end, ramp[min(trunc, loop_len - 1)]),
        ]
    )[: args.n_frames]
    x = ar.gaussian_filter(torch.as_tensor(x, dtype=torch.float32, device=device), 1)

    bends.append(translate_bend(4, modulation=x))  # lower-layer bends give more fluid results
    return bends

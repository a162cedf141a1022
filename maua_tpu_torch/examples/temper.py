"""Spatial noise control with a circular mask, in torch for the port
(counterpart of examples/temper.py; the reference's
audioreactive/examples/temper.py): chroma-weighted latents pulled toward two
chosen latents on drum onsets; the noise inside and outside a soft circle
reacts to the low and the high onsets.

Run:  python -m maua_tpu_torch.pipeline.cli --ckpt g.pt --audio_file track.wav \\
          --audioreactive_file maua_tpu_torch/examples/temper.py

The two normal noise fields of each layer come from `draw_noise`, from a
`torch.Generator` seeded with `hash((height, width))` (the JAX example keys
`jax.random.PRNGKey` with it), so a test can hand in the JAX example's draws.
"""

import numpy as np
import scipy.ndimage as ndi
import torch

import maua_tpu_torch.audio as ar
from maua_tpu_torch.reactive import chroma_weight_latents

OVERRIDE = dict(out_size=1024)


def initialize(args):
    args.lo_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmax=150, smooth=5, clip=97, power=2)
    args.hi_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmin=500, smooth=5, clip=99, power=2)
    return args


def get_latents(selection, args):
    chroma = ar.chroma(args.audio, args.sr, args.n_frames)
    sel = ar.as_tensor(selection, device=chroma.device)
    latents = ar.gaussian_filter(chroma_weight_latents(chroma, sel[: chroma.shape[1]]), 4)

    lo = args.lo_onsets[:, None, None]
    hi = args.hi_onsets[:, None, None]
    latents = hi * sel[-4][None] + (1 - hi) * latents
    latents = lo * sel[-7][None] + (1 - lo) * latents
    return ar.gaussian_filter(latents, 2, causal=0.2)


def circular_mask(h, w, center=None, radius=None, soft=0):
    """[h, w] float32 numpy: 1 inside the circle, softened by a gaussian of
    sigma `soft` (reference: temper.py:41-56)."""
    if center is None:
        center = (int(w / 2), int(h / 2))
    if radius is None:
        radius = min(center[0], center[1], w - center[0], h - center[1])
    Y, X = np.ogrid[:h, :w]
    dist = np.sqrt((X - center[0]) ** 2 + (Y - center[1]) ** 2)
    mask = (dist <= radius).astype(np.float32)
    if soft > 0:
        mask = ndi.gaussian_filter(mask, sigma=int(round(soft)))
    return mask


def draw_noise(n_frames, height, width, device):
    """Two [n_frames, 1, height, width] unit normal fields for one layer."""
    gen = torch.Generator(device=device).manual_seed(hash((height, width)) % 2**31)
    return tuple(torch.randn((n_frames, 1, height, width), generator=gen, device=device) for _ in range(2))


def get_noise(height, width, scale, num_scales, args):
    if width > 256:
        return None

    lo = args.lo_onsets[:, None, None, None]
    hi = args.hi_onsets[:, None, None, None]
    mask = torch.from_numpy(circular_mask(height, width, radius=int(width / 2), soft=2)).to(lo.device)[None, None]

    noisy, smooth = draw_noise(args.n_frames, height, width, lo.device)
    noise_noisy = ar.gaussian_filter(noisy, 5)
    noise = ar.gaussian_filter(smooth, 128)

    if width < 128:
        noise = 2 * mask * lo * noise_noisy + (1 - mask) * (1 - lo) * noise
    if width > 32:
        noise = 0.75 * (1 - mask) * hi * noise_noisy + mask * (1 - 0.75 * hi) * noise

    return noise / (torch.std(noise, correction=0) * 2)

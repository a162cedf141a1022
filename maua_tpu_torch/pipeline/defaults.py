"""Default audio-reactivity plugin (counterpart of
maua_tpu/pipeline/defaults.py): onset-modulated chroma-weighted latents +
two-band reactive noise. The noise's random draws (`_draw`) come from a
`torch.Generator` on the onsets' device seeded with hash((height, width,
scale)) and are kept apart from the arithmetic that uses them
(`_noise_from`)."""

from __future__ import annotations

import torch

from .. import audio as ar
from ..reactive import chroma_weight_latents


def initialize(args):
    args.lo_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmax=150, smooth=5, clip=97, power=2)
    args.hi_onsets = ar.onsets(args.audio, args.sr, args.n_frames, fmin=500, smooth=5, clip=99, power=2)
    return args


def get_latents(selection, args):
    # chroma needs one latent per note; subset the scale when fewer latents were selected
    n_notes = min(12, len(selection))
    chroma = ar.chroma(args.audio, args.sr, args.n_frames, notes=n_notes)
    sel = ar.as_tensor(selection, device=chroma.device)
    latents = ar.gaussian_filter(chroma_weight_latents(chroma, sel[:n_notes]), 4)

    lo = args.lo_onsets[:, None, None]
    hi = args.hi_onsets[:, None, None]
    latents = hi * sel[-4][None] + (1 - hi) * latents
    latents = lo * sel[-7][None] + (1 - lo) * latents

    return ar.gaussian_filter(latents, 2, causal=0.2)


def _draw(height: int, width: int, scale: int, n_frames: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The two N(0, 1) noise volumes [n_frames, 1, height, width] of one layer."""
    rng = torch.Generator(device=device).manual_seed(hash((height, width, scale)) % 2**31)
    shape = (n_frames, 1, height, width)
    return (torch.randn(shape, generator=rng, device=device), torch.randn(shape, generator=rng, device=device))


def _noise_from(noisy: torch.Tensor, smooth: torch.Tensor, width: int, args) -> torch.Tensor:
    lo = args.lo_onsets[:, None, None, None]
    hi = args.hi_onsets[:, None, None, None]
    noise_noisy = ar.gaussian_filter(noisy, 5)
    noise = ar.gaussian_filter(smooth, 128)
    if width < 128:
        noise = lo * noise_noisy + (1 - lo) * noise
    if width > 32:
        noise = hi * noise_noisy + (1 - hi) * noise
    return noise / (torch.std(noise, correction=0) * 2.5)


def get_noise(height, width, scale, num_scales, args):
    if width > 256:
        return None
    noisy, smooth = _draw(height, width, scale, args.n_frames, args.lo_onsets.device)
    return _noise_from(noisy, smooth, width, args)

"""Harmonic/percussive source separation (counterpart of
maua_tpu/audio/hpss.py): median-smooth the magnitude spectrogram along time
(harmonic enhancement) and along frequency (percussive enhancement), build
margin-thresholded masks, apply them to the complex STFT and invert."""

from __future__ import annotations

import torch

from .dsp import istft, pad_axis, stft
from .postprocess import as_tensor, median


def _median_filter_axis(x: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    """Running median along `axis` with edge replication, static window."""
    half = size // 2
    x_m = torch.movedim(x, axis, -1)
    n = x_m.shape[-1]
    win = pad_axis(x_m, -1, half, half, "edge").unfold(-1, size, 1)[..., :n, :]  # [..., n, size]
    return torch.movedim(median(win, dim=-1), -1, axis)


def hpss_masks(S_mag: torch.Tensor, kernel_size: int = 31, power: float = 2.0, margin: float = 1.0):
    """Soft (margin 1) or hard masks from a magnitude spectrogram [freq, time]."""
    harm = _median_filter_axis(S_mag, kernel_size, axis=1)  # smooth over time
    perc = _median_filter_axis(S_mag, kernel_size, axis=0)  # smooth over freq
    if margin == 1.0:
        h_p = harm**power
        p_p = perc**power
        tot = h_p + p_p
        tiny = torch.finfo(S_mag.dtype).tiny
        mask_h = torch.where(tot > tiny, h_p / torch.clamp(tot, min=tiny), 0.5)
        mask_p = torch.where(tot > tiny, p_p / torch.clamp(tot, min=tiny), 0.5)
    else:
        mask_h = (harm > margin * perc).to(S_mag.dtype)
        mask_p = (perc > margin * harm).to(S_mag.dtype)
    return mask_h, mask_p


def _separate(y, margin: float, which: tuple[int, ...], n_fft: int, hop_length: int, kernel_size: int):
    y = as_tensor(y)
    S = stft(y, n_fft=n_fft, hop_length=hop_length)
    masks = hpss_masks(torch.abs(S), kernel_size=kernel_size, margin=margin)
    return tuple(istft(S * masks[i].to(S.dtype), n_fft=n_fft, hop_length=hop_length, length=y.shape[0]) for i in which)


def hpss(y, margin: float = 1.0, n_fft: int = 2048, hop_length: int = 512, kernel_size: int = 31):
    """Return (harmonic, percussive) components of waveform y."""
    return _separate(y, margin, (0, 1), n_fft, hop_length, kernel_size)


def harmonic(y, margin: float = 16.0, n_fft: int = 2048, hop_length: int = 512, kernel_size: int = 31) -> torch.Tensor:
    """rosa.effects.harmonic equivalent (only the harmonic part is inverted)."""
    return _separate(y, margin, (0,), n_fft, hop_length, kernel_size)[0]


def percussive(y, margin: float = 8.0, n_fft: int = 2048, hop_length: int = 512, kernel_size: int = 31) -> torch.Tensor:
    """rosa.effects.percussive equivalent (only the percussive part is inverted)."""
    return _separate(y, margin, (1,), n_fft, hop_length, kernel_size)[0]

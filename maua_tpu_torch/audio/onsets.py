"""Onset envelopes: librosa-style spectral flux and the madmom 5-function
ensemble (counterpart of maua_tpu/audio/onsets.py): percussive separation ->
onset function -> FFT-resample to n_frames -> gaussian smooth -> peak
percentile clip -> power."""

from __future__ import annotations

import numpy as np
import torch

from .dsp import filterbank_tensor, log_filterbank, melspectrogram, pad_axis, power_to_db, resample_signal, stft
from .hpss import percussive
from .postprocess import as_tensor, gaussian_filter, percentile_clip


def onset_strength(
    y,
    sr: int = 22050,
    n_fft: int = 2048,
    hop_length: int = 512,
    n_mels: int = 128,
    fmin: float = 20.0,
    fmax: float = 8000.0,
    lag: int = 1,
) -> torch.Tensor:
    """librosa.onset.onset_strength equivalent: mean over mel bands of the
    half-wave-rectified dB-spectrogram first difference, zero-padded at the
    start by `lag` frames."""
    S = power_to_db(melspectrogram(y, sr=sr, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels, fmin=fmin, fmax=fmax))
    env = torch.mean(torch.clamp(S[:, lag:] - S[:, :-lag], min=0.0), dim=0)
    return torch.cat([env.new_zeros(lag), env])


def _max_filter_freq(x: torch.Tensor, size: int = 3) -> torch.Tensor:
    """Max filter along the frequency axis (superflux vibrato suppression)."""
    half = size // 2
    return pad_axis(x, 0, half, half, "edge").unfold(0, size, 1).amax(dim=-1)


def madmom_onset_ensemble(
    y,
    sr: int = 22050,
    frame_size: int = 2048,
    hop_size: int = 441,
    num_bands: int = 24,
    fmin: float = 20.0,
    fmax: float = 8000.0,
) -> torch.Tensor:
    """Sum of 5 onset functions on a 24-band log-filtered spectrogram:
    spectral_diff + spectral_flux + superflux + complex_flux +
    modified_kullback_leibler."""
    X = stft(y, n_fft=frame_size, hop_length=hop_size, circular_shift=True)  # [F, T]
    mag = torch.abs(X)
    fb = filterbank_tensor(log_filterbank(sr, frame_size, num_bands, fmin, fmax), mag)
    S = fb @ mag  # [bands, T]
    eps = torch.tensor(np.spacing(1.0), dtype=S.dtype, device=S.device)

    hwr = torch.clamp(S[:, 1:] - S[:, :-1], min=0.0)
    spectral_diff = torch.sum(hwr**2, dim=0)
    spectral_flux = torch.sum(hwr, dim=0)

    # superflux: log-magnitude, max-filtered previous frame, lag 1
    logS = torch.log10(5.0 * S + 1.0)
    prev_max = _max_filter_freq(logS, 3)[:, :-1]
    superflux = torch.sum(torch.clamp(logS[:, 1:] - prev_max, min=0.0), dim=0)

    # complex flux: deviation from the constant-phase prediction 2 phi[t-1] - phi[t-2]
    phase = torch.angle(X)
    pred = 2.0 * phase[:, 1:-1] - phase[:, :-2]
    target = X[:, 2:]
    predicted = torch.polar(torch.abs(target), pred)
    cflux = fb @ torch.abs(target - predicted)
    complex_flux = torch.cat([S.new_zeros(1), torch.sum(cflux, dim=0)])

    mkl = torch.sum(torch.log(1.0 + S[:, 1:] / (S[:, :-1] + eps)), dim=0)

    total = spectral_diff + spectral_flux + superflux + complex_flux + mkl
    return torch.cat([S.new_zeros(1), total])


def onsets(
    audio,
    sr: int,
    n_frames: int,
    margin: float = 8.0,
    fmin: float = 20.0,
    fmax: float = 8000.0,
    smooth: float = 1.0,
    clip: float = 100.0,
    power: float = 1.0,
    type: str = "mm",
) -> torch.Tensor:
    """Onset envelope [n_frames] in [0, 1]: percussive separation -> onset
    function -> resample(n_frames) -> smooth -> percentile-clip -> **power."""
    y_perc = percussive(as_tensor(audio), margin=margin)
    if type == "rosa":
        env = onset_strength(y_perc, sr=sr, fmin=fmin, fmax=fmax)
    else:
        env = madmom_onset_ensemble(y_perc, sr=sr, fmin=fmin, fmax=fmax)
    env = torch.clamp(resample_signal(env, n_frames), torch.min(env), torch.max(env))
    env = gaussian_filter(env, smooth, causal=0.0)
    env = percentile_clip(env, clip)
    return env**power

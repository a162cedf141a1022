"""RMS envelopes, MFCCs and derived reactive signals (counterpart of
maua_tpu/audio/features.py). The Butterworth band-pass runs on the host with
scipy, as in the JAX package; its output goes back to the input's device."""

from __future__ import annotations

import numpy as np
import scipy.signal
import torch

from .dsp import filterbank_tensor, melspectrogram, power_to_db, resample_signal, stft
from .postprocess import as_tensor, device_of, gaussian_filter, percentile_clip, to_numpy


def bandpass(y, sr: int, fmin: float, fmax: float, order: int = 12) -> np.ndarray:
    """Butterworth band-pass on the host (numpy in, numpy out)."""
    nyq = sr / 2
    fmax = min(fmax, nyq * 0.999)
    sos = scipy.signal.butter(order, [fmin, fmax], "bp", fs=sr, output="sos")
    return scipy.signal.sosfilt(sos, to_numpy(y)).astype(np.float32)


def frame_rms(y, n_fft: int = 2048, hop_length: int = 512) -> torch.Tensor:
    """Per-frame RMS from the magnitude STFT (rosa.feature.rms(S=|stft|)):
    one-sided spectrum, DC and Nyquist counted once."""
    power = torch.square(torch.abs(stft(y, n_fft=n_fft, hop_length=hop_length)))
    power[0] *= 0.5
    if n_fft % 2 == 0:
        power[-1] *= 0.5
    return torch.sqrt(2.0 * torch.sum(power, dim=0) / n_fft**2)


def rms(
    y,
    sr: int,
    n_frames: int,
    fmin: float = 20.0,
    fmax: float = 8000.0,
    smooth: float = 180.0,
    clip: float = 50.0,
    power: float = 6.0,
) -> torch.Tensor:
    """RMS envelope: bandpass -> framewise rms -> resample -> smooth (slightly
    causal) -> percentile-clip -> **power."""
    env = frame_rms(torch.as_tensor(bandpass(y, sr, fmin, fmax), device=device_of(y)))
    env = torch.clamp(resample_signal(env, n_frames), torch.min(env), torch.max(env))
    env = gaussian_filter(env, smooth, causal=0.05)
    env = percentile_clip(env, clip)
    return env**power


def _dct_ii(n_out: int, n_in: int) -> np.ndarray:
    """Orthonormal DCT-II basis [n_out, n_in] (librosa mfcc convention)."""
    k = np.arange(n_out)[:, None]
    n = np.arange(n_in)[None, :]
    basis = np.cos(np.pi * k * (2 * n + 1) / (2 * n_in))
    basis *= np.sqrt(2.0 / n_in)
    basis[0] *= 1.0 / np.sqrt(2.0)
    return basis


def mfcc(y, sr: int = 22050, n_mfcc: int = 20, n_mels: int = 128, n_fft: int = 2048, hop_length: int = 512) -> torch.Tensor:
    """MFCCs [n_mfcc, T]: DCT-II of the dB mel spectrogram."""
    S = power_to_db(melspectrogram(as_tensor(y), sr=sr, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels))
    return filterbank_tensor(_dct_ii(n_mfcc, n_mels), S) @ S


def drop_strength(y, sr: int, n_frames: int, smooth: float = 20.0) -> torch.Tensor:
    """Low-frequency energy envelope ("drops"): rms of the bass band."""
    return rms(y, sr, n_frames, fmin=20, fmax=160, smooth=smooth, clip=60, power=2)

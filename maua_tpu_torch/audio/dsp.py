"""Core DSP in PyTorch: framing, STFT/ISTFT, filterbanks, dB scaling,
resampling (counterpart of maua_tpu/audio/dsp.py).

Everything computes on the device of its tensor input (numpy inputs go to the
audio package's default device). FFTs are `torch.fft` (cuFFT on a card). The
filterbanks are numpy, built on the host once per call, as in the JAX package.
Padding follows numpy's rules for any pad size (`pad_axis`): PyTorch's
reflect pad refuses pads as large as the dimension.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .postprocess import as_tensor


def pad_indices(n: int, before: int, after: int, mode: str, device=None) -> torch.Tensor:
    """Source index of each position of an axis of length n padded by
    (before, after), by numpy's rule for `mode`: reflect (period 2(n-1)),
    symmetric (period 2n), edge, wrap."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        period = 2 * (n - 1)
        m = i % period
        return torch.where(m < n, m, period - m)
    if mode == "symmetric":
        m = i % (2 * n)
        return torch.where(m < n, m, 2 * n - 1 - m)
    if mode == "edge":
        return torch.clamp(i, 0, n - 1)
    if mode == "wrap":
        return i % n
    raise ValueError(f"unsupported pad mode {mode!r}")


def pad_axis(x: torch.Tensor, dim: int, before: int, after: int, mode: str = "reflect") -> torch.Tensor:
    """np.pad of one axis of x with numpy's `mode` (and "constant": zeros)."""
    if before == 0 and after == 0:
        return x
    if mode == "constant":
        shape = list(x.shape)
        shape[dim] = before
        lo = x.new_zeros(shape)
        shape[dim] = after
        return torch.cat([lo, x, x.new_zeros(shape)], dim=dim)
    return x.index_select(dim, pad_indices(x.shape[dim], before, after, mode, x.device))


def hann_window(n: int, periodic: bool = True, device=None) -> torch.Tensor:
    m = n if periodic else n - 1
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * torch.arange(n, dtype=torch.float32, device=device) / m)


def frame_signal(y, frame_length: int, hop_length: int, center: bool = True, pad_mode: str = "reflect") -> torch.Tensor:
    """Slice y [T] into overlapping frames [n_frames, frame_length] (a view
    of the padded signal)."""
    y = as_tensor(y)
    if center:
        y = pad_axis(y, 0, frame_length // 2, frame_length // 2, pad_mode)
    return y.unfold(0, frame_length, hop_length)


def stft(y, n_fft: int = 2048, hop_length: int = 512, center: bool = True, circular_shift: bool = False) -> torch.Tensor:
    """STFT -> complex [1 + n_fft//2, n_frames] (librosa layout).

    circular_shift rotates each windowed frame by n_fft//2 before the FFT
    (madmom's phase convention; magnitudes are unaffected)."""
    y = as_tensor(y)
    w = hann_window(n_fft, device=y.device)
    frames = frame_signal(y, n_fft, hop_length, center=center) * w[None, :]
    if circular_shift:
        frames = torch.roll(frames, n_fft // 2, dims=1)
    return torch.fft.rfft(frames, n=n_fft, dim=1).T


def istft(spec: torch.Tensor, n_fft: int = 2048, hop_length: int = 512, length: int | None = None) -> torch.Tensor:
    """Inverse STFT with Hann overlap-add (`index_add_`) and COLA
    normalization. spec: complex [1 + n_fft//2, n_frames], centered analysis."""
    w = hann_window(n_fft, device=spec.device)
    frames = torch.fft.irfft(spec.T, n=n_fft, dim=1) * w[None, :]
    n_frames = frames.shape[0]
    out_len = n_fft + hop_length * (n_frames - 1)

    idx = ((torch.arange(n_frames, device=spec.device) * hop_length)[:, None]
           + torch.arange(n_fft, device=spec.device)[None, :]).reshape(-1)
    y = frames.new_zeros(out_len).index_add_(0, idx, frames.reshape(-1))
    wsum = frames.new_zeros(out_len).index_add_(0, idx, (w**2).repeat(n_frames))
    y = y / torch.clamp(wsum, min=1e-8)

    y = y[n_fft // 2 :]
    if length is not None:
        y = y[:length]
    return y


def hz_to_mel(f):
    """Slaney mel scale (librosa default)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mel = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(sr: int, n_fft: int, n_mels: int = 128, fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank [n_mels, 1+n_fft//2]."""
    if fmax is None:
        fmax = sr / 2
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fb = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lo, ctr, hi = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[i] = np.maximum(0, np.minimum(up, down))
        fb[i] *= 2.0 / (hi - lo)
    return fb


def log_filterbank(sr: int, n_fft: int, bands_per_octave: int = 24, fmin: float = 20.0, fmax: float = 8000.0) -> np.ndarray:
    """madmom-style logarithmically-spaced triangular filterbank
    [n_bands, 1+n_fft//2] with unit-area triangles."""
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    n_oct = np.log2(fmax / fmin)
    n_bands = int(np.floor(n_oct * bands_per_octave)) + 1
    centers = fmin * 2.0 ** (np.arange(-1, n_bands + 1) / bands_per_octave)
    # snap centers to fft bins, dedup (madmom behavior at low freqs)
    bins = np.unique(np.round(centers / (sr / 2) * (n_fft // 2)).astype(int))
    bins = bins[(bins > 0) & (bins < len(fft_freqs))]
    filters = []
    for lo, ctr, hi in zip(bins[:-2], bins[1:-1], bins[2:]):
        f = np.zeros(len(fft_freqs))
        if ctr > lo:
            f[lo:ctr] = np.linspace(0, 1, ctr - lo, endpoint=False)
        f[ctr] = 1.0
        if hi > ctr:
            f[ctr:hi] = np.linspace(1, 0, hi - ctr, endpoint=False)
        s = f.sum()
        if s > 0:
            filters.append(f / s * (hi - lo) / 2)  # ~unit response
    return np.stack(filters) if filters else np.zeros((0, len(fft_freqs)))


def filterbank_tensor(fb: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(fb, dtype=like.dtype, device=like.device)


def melspectrogram(
    y,
    sr: int = 22050,
    n_fft: int = 2048,
    hop_length: int = 512,
    n_mels: int = 128,
    power: float = 2.0,
    fmin: float = 0.0,
    fmax: float | None = None,
) -> torch.Tensor:
    """Mel power spectrogram [n_mels, n_frames]."""
    S = torch.abs(stft(y, n_fft=n_fft, hop_length=hop_length)) ** power
    return filterbank_tensor(mel_filterbank(sr, n_fft, n_mels, fmin, fmax), S) @ S


def power_to_db(S: torch.Tensor, ref=1.0, amin: float = 1e-10, top_db: float | None = 80.0) -> torch.Tensor:
    log_spec = 10.0 * torch.log10(torch.clamp(S, min=amin))
    ref = torch.as_tensor(ref, dtype=S.dtype, device=S.device)
    log_spec = log_spec - 10.0 * torch.log10(torch.clamp(ref, min=amin))
    if top_db is not None:
        log_spec = torch.maximum(log_spec, torch.max(log_spec) - top_db)
    return log_spec


def amplitude_to_db(S: torch.Tensor, ref=1.0, amin: float = 1e-5, top_db: float | None = 80.0) -> torch.Tensor:
    return power_to_db(torch.square(S), ref=ref**2, amin=amin**2, top_db=top_db)


def resample_signal(x, n_out: int) -> torch.Tensor:
    """FFT-domain resampling of the time (first) axis to n_out samples (the
    scipy.signal.resample used to map feature frames onto video frames)."""
    x = as_tensor(x)
    n_in = x.shape[0]
    if n_in == n_out:
        return x
    X = torch.fft.rfft(x, dim=0)
    n_keep = min(n_in, n_out) // 2 + 1
    Y = X.new_zeros((n_out // 2 + 1,) + tuple(X.shape[1:]))
    Y[:n_keep] = X[:n_keep]
    # the shared Nyquist bin keeps its real part when truncating to an even length
    if n_out < n_in and n_out % 2 == 0:
        Y[n_keep - 1] = Y[n_keep - 1].real.to(Y.dtype)
    return torch.fft.irfft(Y, n=n_out, dim=0) * (n_out / n_in)

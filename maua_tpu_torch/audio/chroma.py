"""Chromagrams: stft / cqt / cens / clp variants + nearest-neighbor smoothing
(counterpart of maua_tpu/audio/chroma.py): harmonic separation -> chromagram
(cens default) -> optional cosine nn_filter -> resample to n_frames -> keep
the `notes` pitch classes with the lowest median -> row-normalize.

The CQT is a pseudo-CQT: a log-spaced triangular filterbank over a long (8192)
STFT, one matmul. Medians of even counts average the two middle values, as
numpy's do."""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..models.blocks import tf32
from .dsp import filterbank_tensor, resample_signal, stft
from .hpss import harmonic
from .postprocess import as_tensor, median


def cqt_filterbank(sr: int, n_fft: int, n_bins: int = 84, bins_per_octave: int = 12, fmin: float = 32.703) -> np.ndarray:
    """Triangular log-frequency filterbank [n_bins, 1+n_fft//2]; fmin
    defaults to C1 (librosa convention)."""
    freqs = fmin * 2.0 ** (np.arange(n_bins) / bins_per_octave)
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    fb = np.zeros((n_bins, len(fft_freqs)))
    for i, f in enumerate(freqs):
        lo = f * 2.0 ** (-1.0 / bins_per_octave)
        hi = f * 2.0 ** (1.0 / bins_per_octave)
        up = (fft_freqs - lo) / max(f - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - f, 1e-10)
        fb[i] = np.maximum(0, np.minimum(up, down))
        s = fb[i].sum()
        if s > 0:
            fb[i] /= s
    return fb


def pseudo_cqt(
    y,
    sr: int = 22050,
    n_bins: int = 84,
    bins_per_octave: int = 12,
    n_fft: int = 8192,
    hop_length: int = 512,
    fmin: float = 32.703,
) -> torch.Tensor:
    """Pseudo constant-Q magnitude [n_bins, T]."""
    S = torch.abs(stft(y, n_fft=n_fft, hop_length=hop_length))
    return filterbank_tensor(cqt_filterbank(sr, n_fft, n_bins, bins_per_octave, fmin), S) @ S


def _fold_chroma(C: torch.Tensor, bins_per_octave: int = 12, n_chroma: int = 12) -> torch.Tensor:
    """Fold CQT bins into pitch classes. fmin=C1 puts bin 0 on pitch class C."""
    idx = (torch.arange(C.shape[0], device=C.device) * n_chroma // bins_per_octave) % n_chroma
    return C.new_zeros((n_chroma, C.shape[1])).index_add_(0, idx, C)


def _normalize_cols(C: torch.Tensor, ord_: float = math.inf) -> torch.Tensor:
    if ord_ == math.inf:
        denom = torch.amax(torch.abs(C), dim=0, keepdim=True)
    else:
        denom = torch.sum(torch.abs(C) ** ord_, dim=0, keepdim=True) ** (1.0 / ord_)
    return C / torch.clamp(denom, min=1e-12)


def chroma_cqt(y, sr: int = 22050, hop_length: int = 512) -> torch.Tensor:
    """Energy-normalized chroma from pseudo-CQT [12, T]."""
    return _normalize_cols(_fold_chroma(pseudo_cqt(y, sr=sr, hop_length=hop_length)))


def chroma_stft(y, sr: int = 22050, n_fft: int = 2048, hop_length: int = 512) -> torch.Tensor:
    """STFT-based chroma [12, T]: power spectrogram through a gaussian-windowed
    pitch-class projection."""
    S = torch.abs(stft(y, n_fft=n_fft, hop_length=hop_length)) ** 2
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)[1:]
    frac_bin = 12 * np.log2(fft_freqs / 440.0) + 69  # midi note number
    fb = np.zeros((12, 1 + n_fft // 2))
    for c in range(12):
        d = np.mod(frac_bin - c + 6, 12) - 6  # distance in semitones, wrapped
        fb[c, 1:] = np.exp(-0.5 * (d / 1.0) ** 2)
    fb /= np.maximum(fb.sum(axis=0, keepdims=True), 1e-12)
    return _normalize_cols(filterbank_tensor(fb, S) @ S)


def chroma_cens(y, sr: int = 22050, hop_length: int = 512, win_len: int = 41) -> torch.Tensor:
    """CENS chroma [12, T]: l1-normalize, amplitude quantization
    (0.4/0.2/0.1/0.05 steps), Hann smoothing over time (conv1d, TF32 off),
    l2 normalize."""
    C = chroma_cqt(y, sr=sr, hop_length=hop_length)
    C = C / torch.clamp(torch.sum(torch.abs(C), dim=0, keepdim=True), min=1e-12)
    Q = torch.zeros_like(C)
    for step in (0.4, 0.2, 0.1, 0.05):
        Q = Q + 0.25 * (C > step).to(C.dtype)
    w = torch.as_tensor(np.hanning(win_len), dtype=C.dtype, device=C.device)
    w = w / torch.sum(w)
    pad = win_len // 2
    with tf32(conv=False, matmul=False):
        sm = F.conv1d(F.pad(Q, (pad, pad))[:, None, :], torch.flip(w, (0,))[None, None, :])[:, 0, :]
    return sm / torch.clamp(torch.sqrt(torch.sum(sm**2, dim=0, keepdim=True)), min=1e-12)


def chroma_clp(y, sr: int = 22050, hop_length: int = 512, eta: float = 100.0) -> torch.Tensor:
    """CLP chroma [12, T]: semitone-band energies -> log(1 + eta e) ->
    pitch-class fold -> per-frame l2 normalization."""
    L = torch.log1p(eta * pseudo_cqt(y, sr=sr, hop_length=hop_length) ** 2)
    C = _fold_chroma(L)
    return C / torch.clamp(torch.sqrt(torch.sum(C**2, dim=0, keepdim=True)), min=1e-12)


def nn_filter_cosine(C: torch.Tensor, k: int | None = None) -> torch.Tensor:
    """Nearest-neighbor median smoothing over time using cosine similarity
    (librosa.decompose.nn_filter equivalent): each column becomes the median
    of its k most similar other columns."""
    C = as_tensor(C)
    T = C.shape[1]
    if T < 3:
        return C
    if k is None:
        k = min(T - 1, max(2, int(np.ceil(np.sqrt(T)))))
    Cn = C / torch.clamp(torch.linalg.vector_norm(C, dim=0, keepdim=True), min=1e-12)
    with tf32(conv=False, matmul=False):
        sim = Cn.T @ Cn  # [T, T]
    sim.fill_diagonal_(-math.inf)
    nn_idx = torch.topk(sim, k, dim=1).indices  # [T, k]
    return median(C[:, nn_idx], dim=2)  # [12, T]


def raw_chroma(audio, sr: int, type: str = "cens", nearest_neighbor: bool = True) -> torch.Tensor:
    """Chromagram [12, T]. Unknown types fall back to cens; 'deep' (madmom's
    trained DeepChroma network) substitutes CLP with a warning."""
    y = as_tensor(audio)
    if type == "cqt":
        ch = chroma_cqt(y, sr=sr)
    elif type == "stft":
        ch = chroma_stft(y, sr=sr)
    elif type == "clp":
        ch = chroma_clp(y, sr=sr)
    elif type == "deep":
        warnings.warn(
            "chroma type 'deep' (madmom DeepChromaProcessor, a trained neural "
            "net) has no equivalent here; substituting CLP chroma "
            "(log-compressed pitch), the closest deterministic log-frequency mapping.",
            stacklevel=2,
        )
        ch = chroma_clp(y, sr=sr)
    else:  # cens, unknown
        ch = chroma_cens(y, sr=sr)
    if nearest_neighbor:
        ch = torch.minimum(ch, nn_filter_cosine(ch))
    return ch


def chroma(audio, sr: int, n_frames: int, margin: float = 16.0, type: str = "cens", notes: int = 12) -> torch.Tensor:
    """Harmonic chromagram resampled to frames [n_frames, notes]: the `notes`
    pitch classes with the lowest median, each row normalized to sum 1."""
    y_harm = harmonic(as_tensor(audio), margin=margin)
    ch = resample_signal(raw_chroma(y_harm, sr, type=type).T, n_frames)  # [n_frames, 12]
    notes_indices = torch.argsort(median(ch, dim=0), stable=True)[:notes]
    ch = ch[:, notes_indices]
    return ch / torch.clamp(ch.sum(1)[:, None], min=1e-12)

"""Envelope post-processing: normalize / percentile-clip / compress / smooth
(counterpart of maua_tpu/audio/postprocess.py).

Two module globals, both set by `generate()`: the smoothing fps factor `SMF`
(fps / 30) and the default device of the audio package, on which inputs that
are not tensors (numpy arrays, lists) are placed. A tensor input keeps its own
device. The default device is `cuda` unless set; without a card, reading it
raises RuntimeError (pass `set_device("cpu")` to run on the CPU).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..models.blocks import tf32

SMF = 1.0  # smoothing fps factor; set_SMF(fps/30)
DEVICE: DeviceLike = None  # default device for inputs that are not tensors (None = cuda)


def set_SMF(smf: float) -> None:
    global SMF
    SMF = float(smf)


def get_SMF() -> float:
    return SMF


def set_device(device: DeviceLike) -> None:
    """Default device for inputs that are not tensors (None = cuda)."""
    global DEVICE
    DEVICE = device


def get_device() -> torch.device:
    return resolve_device(DEVICE)


def as_tensor(x, dtype: Optional[torch.dtype] = torch.float32, device: DeviceLike = None) -> torch.Tensor:
    """x as a tensor of `dtype` (None keeps a tensor's dtype): on `device`
    when given, else on x's own device when x is a tensor, else on the
    package's default device."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype if dtype is not None else x.dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=resolve_device(device) if device is not None else get_device())


def device_of(x) -> torch.device:
    """x's device when it is a tensor, else the package's default device."""
    return x.device if isinstance(x, torch.Tensor) else get_device()


def to_numpy(x) -> np.ndarray:
    """x on the host as a numpy array (host-only stages: scipy, plots)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def median(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """np.median along `dim`: the mean of the two middle values for an even
    count (torch.median returns the lower one)."""
    n = x.shape[dim]
    if n % 2:
        return torch.median(x, dim=dim).values
    s = torch.sort(x, dim=dim).values
    return 0.5 * (s.narrow(dim, n // 2 - 1, 1) + s.narrow(dim, n // 2, 1)).squeeze(dim)


def normalize(signal) -> torch.Tensor:
    """Min-max normalize to [0, 1]."""
    signal = as_tensor(signal)
    signal = signal - torch.min(signal)
    return signal / torch.clamp(torch.max(signal), min=1e-12)


def percentile(signal, p: float) -> torch.Tensor:
    """kthvalue-style percentile."""
    signal = as_tensor(signal).reshape(-1)
    k = 1 + round(0.01 * float(p) * (signal.numel() - 1))
    return torch.sort(signal).values[k - 1]


def percentile_clip(signal, p: float) -> torch.Tensor:
    """Normalize to [0,1], clipping above the p-th percentile of *local peaks*
    (the percentile of the whole signal when it has no peak). The peak count
    stays on the device: non-peaks are pushed to +inf before one sort."""
    signal = as_tensor(signal)
    n = signal.shape[0]
    locs = torch.arange(n, device=signal.device)
    plus = signal[torch.clamp(locs + 1, 0, n - 1)]
    minus = signal[torch.clamp(locs - 1, 0, n - 1)]
    peak_mask = ((signal > plus) & (signal > minus)).reshape(-1)
    flat = signal.reshape(-1)
    sorted_peaks = torch.sort(flat.masked_fill(~peak_mask, float("inf"))).values
    n_peaks = peak_mask.sum()
    k_peaks = torch.round(0.01 * p * (torch.clamp(n_peaks, min=1) - 1).float()).long()
    k_all = int(np.round(np.float32(0.01 * p * (flat.numel() - 1))))  # rounded in fp32, half to even
    thresh = torch.where(n_peaks > 0, sorted_peaks[k_peaks], torch.sort(flat).values[k_all])
    signal = torch.minimum(torch.clamp(signal, min=0), thresh)
    return signal / torch.clamp(torch.max(signal), min=1e-12)


def compress(signal, threshold: float, ratio: float, invert: bool = False) -> torch.Tensor:
    """Multiply values above (or below when invert) threshold by ratio, then
    renormalize."""
    signal = as_tensor(signal)
    if invert:
        signal = torch.where(signal < threshold, signal * ratio, signal)
    else:
        signal = torch.where(signal > threshold, signal * ratio, signal)
    return normalize(signal)


def expand(signal, threshold: float, ratio: float, invert: bool = False) -> torch.Tensor:
    return compress(signal, threshold, ratio, invert)


def gaussian_filter(x, sigma: float, causal: float | None = None) -> torch.Tensor:
    """Gaussian smoothing along the time (first) axis with circular padding
    and optional causal weighting of the taps after the centre.

    Works for [T], [T,C] and [T,C,H,W] timelines; the radius scales with the
    global SMF fps factor and is capped at 3*T; when it exceeds T the sequence
    is padded circularly by T and with zeros beyond. One shared 1-D
    convolution over [F, 1, T_pad] in fp32 with TF32 off, in chunks of F."""
    x = as_tensor(x)
    n_frames = x.shape[0]
    orig_shape = x.shape
    x2 = x.reshape(n_frames, -1)  # [T, F]

    radius = min(int(sigma * 4 * SMF), 3 * n_frames)
    if radius <= 0:
        return x

    t = torch.arange(-radius, radius + 1, dtype=torch.float32, device=x.device)
    kernel = torch.exp(-0.5 / max(sigma, 1e-6) ** 2 * t**2)
    if causal is not None:
        cf = causal if isinstance(causal, float) else 0.0
        kernel[radius + 1 :] *= cf
    kernel = kernel / torch.sum(kernel)

    if radius > n_frames:
        x2 = torch.cat([x2[-n_frames:], x2, x2[:n_frames]], dim=0)
        pad = radius - n_frames
        x2 = F.pad(x2, (0, 0, pad, pad))
    else:
        x2 = torch.cat([x2[-radius:], x2, x2[:radius]], dim=0)

    seq = x2.T  # [F, T_pad]
    k = torch.flip(kernel, (0,))[None, None, :]
    rows = max(1, (1 << 28) // seq.shape[1])  # bound each call's input to 1 GiB
    with tf32(conv=False, matmul=False):
        out = torch.cat([F.conv1d(c[:, None, :], k)[:, 0, :] for c in seq.split(rows)], dim=0).T  # [T, F]

    out = out.reshape((out.shape[0],) + tuple(orig_shape[1:]))
    return out

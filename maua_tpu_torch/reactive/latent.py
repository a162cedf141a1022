"""Latent timeline construction (counterpart of maua_tpu/reactive/latent.py).

Timelines are tensors on the device of their tensor inputs (numpy inputs go to
the audio package's default device). Slerp keyframes and splines are fitted on
the host, as in the JAX package. `generate_latents` draws its z from a
`torch.Generator` on its device (`_draw_latents`) and maps them with the
checkpoint's mapping network (`_map_latents`)."""

from __future__ import annotations

import numpy as np
import torch
from scipy import interpolate

from ..audio.postprocess import as_tensor, device_of, gaussian_filter, to_numpy
from ..device import DeviceLike, resolve_device


def chroma_weight_latents(chroma, latents) -> torch.Tensor:
    """Chroma-weighted latent mix: chroma [T, N] x latents [N, n_latent, D]
    -> [T, n_latent, D], on chroma's device."""
    chroma = as_tensor(chroma)
    return torch.einsum("tn,nld->tld", chroma, as_tensor(latents, device=chroma.device))


def slerp(val: float, low: np.ndarray, high: np.ndarray) -> np.ndarray:
    """Spherical interpolation along the unit-sphere geodesic (host numpy)."""
    low = np.asarray(low, np.float64)
    high = np.asarray(high, np.float64)
    omega = np.arccos(np.clip(np.dot(low / np.linalg.norm(low), high / np.linalg.norm(high)), -1, 1))
    so = np.sin(omega)
    if so == 0:
        return (1.0 - val) * low + val * high
    return np.sin((1.0 - val) * omega) / so * low + np.sin(val * omega) / so * high


def slerp_loops(
    latent_selection,
    n_frames: int,
    n_loops: int,
    smoothing: float = 1,
    loop: bool = True,
    n_latent: int = 18,
) -> torch.Tensor:
    """Looping latent timeline [n_frames, n_latent, D] via geodesic
    interpolation between the selected latents' first rows."""
    device = device_of(latent_selection)
    sel = to_numpy(latent_selection)
    if loop:
        sel = np.concatenate([sel, sel[[0]]])

    steps = max(1, int(n_frames // max(1, n_loops) // len(sel)))
    base = []
    for n in range(len(sel)):
        for val in np.linspace(0.0, 1.0, steps):
            base.append(slerp(val, sel[n % len(sel)][0], sel[(n + 1) % len(sel)][0]))
    base = gaussian_filter(torch.as_tensor(np.stack(base), dtype=torch.float32, device=device), smoothing)
    reps = max(1, int(n_frames / len(base)))
    base = torch.cat([base] * reps, dim=0)
    base = base[:, None, :].repeat(1, n_latent, 1)
    if n_frames - len(base) > 0:
        base = torch.cat([base, base[: n_frames - len(base)]])
    return base[:n_frames]


def spline_loops(latent_selection, n_frames: int, n_loops: int, loop: bool = True) -> torch.Tensor:
    """Looping latent timeline via cubic-spline interpolation per latent dim,
    fitted on the host."""
    device = device_of(latent_selection)
    sel = to_numpy(latent_selection).astype(np.float64)
    if loop:
        sel = np.concatenate([sel, sel[[0]]])

    x = np.linspace(0, 1, max(4, int(n_frames // max(1, n_loops))))
    xs = np.linspace(0, 1, sel.shape[0])
    flat = sel.reshape(sel.shape[0], -1)  # [K, L*D]
    out = np.empty((len(x), flat.shape[1]))
    for i in range(flat.shape[1]):
        tck = interpolate.splrep(xs, flat[:, i], k=min(3, len(xs) - 1))
        out[:, i] = interpolate.splev(x, tck)
    base = out.reshape(len(x), *sel.shape[1:])

    reps = max(1, int(n_frames / len(base)))
    base = np.concatenate([base] * reps, axis=0)
    if n_frames - len(base) > 0:
        base = np.concatenate([base, base[: n_frames - len(base)]])
    return torch.as_tensor(base[:n_frames], dtype=torch.float32, device=device)


def wrapping_slice(tensor, start: int, length: int, return_indices: bool = False):
    """Length-`length` slice starting at `start`, wrapping around dim 0."""
    tensor = as_tensor(tensor, dtype=None)
    n = tensor.shape[0]
    if n == 1:
        indices = torch.zeros(1, dtype=torch.long, device=tensor.device)
    else:
        indices = torch.arange(start, start + length, device=tensor.device) % n
    if return_indices:
        return indices
    return tensor[indices]


def _draw_latents(n_latents: int, latent_dim: int, seed: int, device: torch.device) -> torch.Tensor:
    """z [n_latents, latent_dim] from a torch.Generator on `device`."""
    rng = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((n_latents, latent_dim), generator=rng, device=device)


def _map_latents(ckpt: str, zs: torch.Tensor, G_res: int, noconst: bool, n_mlp: int, channel_multiplier: int) -> torch.Tensor:
    """W+ [N, n_latent, D] of z through the checkpoint's mapping network."""
    from ..io.torch_ckpt import load_generator

    gen = load_generator(
        ckpt, device=zs.device, size=G_res, style_dim=zs.shape[1], n_mlp=n_mlp,
        channel_multiplier=channel_multiplier, constant_input=not noconst,
    )
    with torch.inference_mode():
        return gen(zs, map_latents=True)


def generate_latents(
    n_latents: int,
    ckpt: str,
    G_res: int = 1024,
    noconst: bool = False,
    latent_dim: int = 512,
    n_mlp: int = 8,
    channel_multiplier: int = 2,
    seed: int = 0,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Random mapped W+ latents from a checkpointed generator on `device`
    (default `cuda`; raises RuntimeError when there is none)."""
    zs = _draw_latents(n_latents, latent_dim, seed, resolve_device(device))
    return _map_latents(ckpt, zs, G_res, noconst, n_mlp, channel_multiplier)


def save_latents(latents, filename: str) -> None:
    np.save(filename, to_numpy(latents))


def load_latents(filename: str) -> torch.Tensor:
    """Latents from a .npy file, on the audio package's default device."""
    return as_tensor(np.load(filename))

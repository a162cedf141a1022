"""Noise timeline generation: 3-D tileable perlin noise + reactive blends
(counterpart of maua_tpu/reactive/noise.py).

The random draws come from a `torch.Generator` (an int seeds a new one on the
audio package's default device) and are kept apart from the arithmetic that
uses them (`_perlin_from_angles`, `_reactive_noise_from`). Perlin noise is
evaluated in chunks of frames by indexing the lattice gradients of each
voxel's cell, the same arithmetic per voxel as the JAX version's repeated
gradient volume without holding that volume."""

from __future__ import annotations

import math
from typing import Union

import torch

from ..audio.postprocess import as_tensor, gaussian_filter, get_device

Rng = Union[int, torch.Generator]


def _generator(rng: Rng) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator(device=get_device()).manual_seed(int(rng))


def _perlinterpolant(t):
    return t * t * t * (t * (t * 6 - 15) + 10)


def _perlin_from_angles(
    theta: torch.Tensor,
    phi: torch.Tensor,
    shape: tuple[int, int, int],
    res: tuple[int, int, int],
    tileable: tuple[bool, bool, bool] = (True, False, False),
) -> torch.Tensor:
    """Perlin noise [T, H, W] in [-1, 1] from the lattice's gradient angles
    theta, phi [res + 1] (radians), on their device."""
    d = tuple(s // r for s, r in zip(shape, res))
    device = theta.device
    gradients = torch.stack(
        (torch.sin(phi) * torch.cos(theta), torch.sin(phi) * torch.sin(theta), torch.cos(phi)), dim=3
    )
    if tileable[0]:
        gradients[-1, :, :] = gradients[0, :, :]
    if tileable[1]:
        gradients[:, -1, :] = gradients[:, 0, :]
    if tileable[2]:
        gradients[:, :, -1] = gradients[:, :, 0]

    # per axis: each voxel's lattice cell and fractional offset inside it
    cells = [torch.arange(s, device=device) // dd for s, dd in zip(shape, d)]
    fracs = [torch.arange(s, dtype=torch.float32, device=device) / dd % 1.0 for s, dd in zip(shape, d)]
    fades = [_perlinterpolant(f) for f in fracs]
    ch, cw = cells[1], cells[2]
    fh, fw = fracs[1][None, :, None], fracs[2][None, None, :]
    th, tw = fades[1][None, :, None], fades[2][None, None, :]

    out = []
    step = max(1, (1 << 22) // (shape[1] * shape[2]))
    for t0 in range(0, shape[0], step):
        ct = cells[0][t0 : t0 + step]
        ft = fracs[0][t0 : t0 + step][:, None, None]
        tt = fades[0][t0 : t0 + step][:, None, None]

        def corner(dx, dy, dz):
            g = gradients[ct + dx][:, ch + dy][:, :, cw + dz]  # [t, H, W, 3]
            return (ft - dx) * g[..., 0] + (fh - dy) * g[..., 1] + (fw - dz) * g[..., 2]

        n00 = corner(0, 0, 0) * (1 - tt) + tt * corner(1, 0, 0)
        n10 = corner(0, 1, 0) * (1 - tt) + tt * corner(1, 1, 0)
        n01 = corner(0, 0, 1) * (1 - tt) + tt * corner(1, 0, 1)
        n11 = corner(0, 1, 1) * (1 - tt) + tt * corner(1, 1, 1)
        n0 = (1 - th) * n00 + th * n10
        n1 = (1 - th) * n01 + th * n11
        out.append((1 - tw) * n0 + tw * n1)
    return torch.cat(out) * 2.0 - 1.0


def perlin_noise(
    rng: Rng,
    shape: tuple[int, int, int],
    res: tuple[int, int, int],
    tileable: tuple[bool, bool, bool] = (True, False, False),
) -> torch.Tensor:
    """3-D perlin noise [T, H, W] in [-1, 1] on rng's device; shape must be a
    multiple of res per axis."""
    for s, r in zip(shape, res):
        if s % r != 0:
            raise ValueError(f"shape {shape} must be a multiple of res {res}")
    g = _generator(rng)
    lattice = (res[0] + 1, res[1] + 1, res[2] + 1)
    theta = 2 * math.pi * torch.rand(lattice, generator=g, device=g.device)
    phi = 2 * math.pi * torch.rand(lattice, generator=g, device=g.device)
    return _perlin_from_angles(theta, phi, shape, res, tileable)


def looping_perlin(rng: Rng, n_frames: int, h: int, w: int, periods: int = 4) -> torch.Tensor:
    """Time-tileable perlin noise timeline [n_frames, 1, h, w] that loops
    seamlessly over the frame axis."""
    t = -(-n_frames // periods) * periods  # round up to a multiple of periods
    res_hw = max(1, min(4, h // 4, w // 4))
    p = perlin_noise(rng, (t, h, w), (periods, res_hw, res_hw), tileable=(True, False, False))
    return p[:n_frames, None]


def _reactive_noise_from(
    base: torch.Tensor, react: torch.Tensor, envelope, base_sigma: float, react_sigma: float
) -> torch.Tensor:
    """Blend smoothed base noise toward smoothed fast noise by the envelope,
    renormalized to unit std."""
    base = gaussian_filter(base, base_sigma)
    react = gaussian_filter(react, react_sigma)
    env = as_tensor(envelope, device=base.device)[:, None, None, None]
    noise = base * (1 - env) + react * env
    return noise / torch.clamp(torch.std(noise, correction=0), min=1e-8)


def reactive_noise(
    rng: Rng,
    envelope,
    h: int,
    w: int,
    base_sigma: float = 20.0,
    react_sigma: float = 1.0,
) -> torch.Tensor:
    """Onset-reactive noise [n_frames, 1, h, w]: slowly-varying base noise
    blended toward fast noise by an envelope [n_frames] in [0, 1]."""
    g = _generator(rng)
    shape = (len(envelope), 1, h, w)
    base = torch.randn(shape, generator=g, device=g.device)
    react = torch.randn(shape, generator=g, device=g.device)
    return _reactive_noise_from(base, react, envelope, base_sigma, react_sigma)

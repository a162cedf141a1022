"""Network bending as functions over activations (counterpart of
maua_tpu/reactive/bend.py).

A `Bend(layer, transform, modulation)` applies `transform(x, mod)` to the
activation [B, C, H, W] of generator layer `layer`, with the batch's slice
`mod` [B] of the modulation timeline (or None). `render()` closes each bend
over its batch's slice; `bends_for_batch` does the same for a caller that
drives the Generator itself.

The geometric bends pad with numpy's reflect rule, which accepts pads larger
than the activation (translate pads 2.5w left and 1.5w right; zoom pads
max(h, w) - 1 on every side, more than h on a widescreen 4x8 layer), then
sample bilinearly at pixel coordinates with zeros outside the image, and crop
the centre. They compute in fp32 and return the activation's dtype.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from ..audio.dsp import pad_axis
from ..ops.gather import bilinear_gather


class Bend(NamedTuple):
    layer: int
    transform: Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]  # (x, mod[B]) -> x
    modulation: Optional[object] = None  # [n_frames] timeline (None = static)


def _pad2d(x: torch.Tensor, left: int, right: int, top: int, bottom: int, mode: str) -> torch.Tensor:
    """np.pad of the last two axes with numpy's `mode` (or "constant"), any pad size."""
    return pad_axis(pad_axis(x, -2, top, bottom, mode), -1, left, right, mode)


def _reflect_pad(x: torch.Tensor, left: int, right: int, top: int = 0, bottom: int = 0) -> torch.Tensor:
    return _pad2d(x, left, right, top, bottom, "reflect")


def _affine_crop(x_pad: torch.Tensor, h: int, w: int, mats: torch.Tensor) -> torch.Tensor:
    """Sample the center h x w crop of x_pad through per-sample inverse-affine
    `mats` [B,2,3] given in output-pixel coordinates (origin at crop center)."""
    b = x_pad.shape[0]
    hp, wp = x_pad.shape[2], x_pad.shape[3]
    cy, cx = (hp - 1) / 2.0, (wp - 1) / 2.0
    ys = torch.arange(h, dtype=torch.float32, device=x_pad.device) - (h - 1) / 2.0
    xs = torch.arange(w, dtype=torch.float32, device=x_pad.device) - (w - 1) / 2.0
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    grid = torch.stack([gx, gy, torch.ones_like(gx)], 0).reshape(3, -1)  # [3, h*w]
    src = torch.einsum("bij,jk->bik", mats, grid)  # [B,2,h*w]
    px = src[:, 0].reshape(b, h, w) + cx
    py = src[:, 1].reshape(b, h, w) + cy
    return bilinear_gather(x_pad, px, py)


def _mod(mod: Optional[torch.Tensor], b: int, fill: float, device) -> torch.Tensor:
    if mod is None:
        return torch.full((b,), fill, dtype=torch.float32, device=device)
    return torch.as_tensor(mod, dtype=torch.float32, device=device)


def add_noise_bend(layer: int, noise, modulation=None) -> Bend:
    """x + (mod *) noise."""

    def transform(x: torch.Tensor, mod: Optional[torch.Tensor] = None) -> torch.Tensor:
        n = torch.as_tensor(noise, device=x.device).to(x.dtype)
        if mod is not None:
            n = n * torch.as_tensor(mod, device=x.device)[:, None, None, None].to(x.dtype)
        return x + n

    return Bend(layer, transform, modulation)


def print_bend(layer: int) -> Bend:
    """Debug bend printing feature statistics."""

    def transform(x: torch.Tensor, mod: Optional[torch.Tensor] = None) -> torch.Tensor:
        xf = x.float()
        print(f"bend[{layer}] shape={tuple(x.shape)} min={xf.min().item()} mean={xf.mean().item()} "
              f"max={xf.max().item()} std={xf.std(correction=0).item()}")
        return x

    return Bend(layer, transform, None)


def translate_bend(layer: int, modulation, noise=None) -> Bend:
    """Seamless horizontal scroll: reflection-pad to 5x width (w/2+w+w |
    w/2+w), add optional noise, translate by mod * w pixels, center-crop; a
    saw-tooth modulation in [0, 1] scrolls exactly one reflected period."""

    def transform(x: torch.Tensor, mod: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, c, h, w = x.shape
        xp = _reflect_pad(x.float(), w // 2 + w + w, w // 2 + w)
        if noise is not None:
            xp = xp + torch.as_tensor(noise, dtype=torch.float32, device=x.device)
        mats = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], device=x.device).repeat(b, 1, 1)
        mats[:, 0, 2] = -_mod(mod, b, 0.0, x.device) * w  # inverse map: src = x - t
        return _affine_crop(xp, h, w, mats).to(x.dtype)

    return Bend(layer, transform, modulation)


def zoom_bend(layer: int, modulation) -> Bend:
    """Zoom by factor mod about the center."""

    def transform(x: torch.Tensor, mod: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, c, h, w = x.shape
        pad = int(max(h, w)) - 1
        xp = _reflect_pad(x.float(), pad, pad, pad, pad)
        inv = 1.0 / torch.clamp(_mod(mod, b, 1.0, x.device), min=1e-4)
        mats = torch.zeros((b, 2, 3), device=x.device)
        mats[:, 0, 0] = inv
        mats[:, 1, 1] = inv
        return _affine_crop(xp, h, w, mats).to(x.dtype)

    return Bend(layer, transform, modulation)


def rotate_bend(layer: int, modulation) -> Bend:
    """Rotate by mod degrees about the center."""

    def transform(x: torch.Tensor, mod: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, c, h, w = x.shape
        pad = int(max(h, w) * (1 - math.sqrt(2) / 2)) + 1
        xp = _reflect_pad(x.float(), pad, pad, pad, pad)
        th = torch.deg2rad(_mod(mod, b, 0.0, x.device))
        cos, sin = torch.cos(th), torch.sin(th)
        mats = torch.zeros((b, 2, 3), device=x.device)
        mats[:, 0, 0], mats[:, 0, 1] = cos, sin
        mats[:, 1, 0], mats[:, 1, 1] = -sin, cos
        return _affine_crop(xp, h, w, mats).to(x.dtype)

    return Bend(layer, transform, modulation)


def pad_bend(layer: int, pad: tuple[int, int, int, int] = (2, 2, 0, 0), mode: str = "edge") -> Bend:
    """Pad bend with numpy's mode names (edge, reflect, symmetric, wrap,
    constant), e.g. the layer-0 (left, right, top, bottom) = (2, 2, 0, 0)
    edge pad that turns the 4x4 constant into 4x8 for 2:1 widescreen."""
    left, right, top, bottom = pad

    def transform(x: torch.Tensor, mod: Optional[torch.Tensor] = None) -> torch.Tensor:
        return _pad2d(x, left, right, top, bottom, mode)

    return Bend(layer, transform, None)


def bends_for_batch(bends: Sequence[Bend], start: int, end: int):
    """Close each bend over its modulation slice [start:end] and return
    (layer, fn(x)) pairs for Generator(bends=...)."""
    out = []
    for b in bends or ():
        mod = None if b.modulation is None else torch.as_tensor(b.modulation[start:end])
        out.append((b.layer, lambda x, _mod=mod, _t=b.transform: _t(x, _mod)))
    return out

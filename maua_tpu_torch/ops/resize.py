"""Bilinear resize with `jax.image.resize(..., "bilinear")`'s semantics.

JAX's bilinear resize samples at half-pixel centres with a triangle kernel
that it widens by the scale factor when it shrinks an axis (an antialiasing
filter) and leaves at one pixel when it enlarges one; each output's weights
are normalised to sum to one. `resize_bilinear` builds the same per-axis
weight matrices in fp32, by the same arithmetic, and applies them as two
matrix products with TF32 off: it matches JAX to about 1e-7 both ways,
including the non-integer ratios (1024 -> 299) where `F.interpolate(...,
antialias=True)` rounds its weights differently by 2e-6. It is differentiable
(the projector resizes inside its loss).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.blocks import tf32

__all__ = ["resize_bilinear"]


def _weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] weights of one axis (jax.image's compute_weight_mat with
    the triangle kernel, translation 0, antialias on)."""
    inv_scale = float(np.float32(n_in / n_out))
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs() / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps), w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_bilinear(img: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """[N, C, H, W] -> [N, C, *size], bilinear, antialiased when it shrinks."""
    h, w = img.shape[-2:]
    out_h, out_w = size
    with tf32(conv=False, matmul=False):
        if out_w != w:
            img = img @ _weights(w, out_w, img.device).to(img.dtype)
        if out_h != h:
            img = (img.transpose(-1, -2) @ _weights(h, out_h, img.device).to(img.dtype)).transpose(-1, -2)
    return img

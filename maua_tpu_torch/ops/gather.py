"""Bilinear gather at pixel coordinates, zeros outside the image.

The one gather of the port: ADA's affine warp (`train/augment.py`) and the
geometric bends (`reactive/bend.py`) sample through it. Four
`torch.gather`s and a lerp, as the JAX package's `_bilinear_sample_plain`
(maua_tpu/train/augment.py:349-382); autograd's backward is the matching
scatter-add.
"""

from __future__ import annotations

import torch

__all__ = ["bilinear_gather"]


def bilinear_gather(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """img [B, C, H, W]; px, py [B, Ho, Wo] fp32 pixel coordinates (integer
    values hit pixel centres). Returns [B, C, Ho, Wo] in img's dtype: the
    four neighbours, each zero outside the image, weighted by the fractional
    parts cast to img's dtype."""
    b, c, h, w = img.shape
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx = (px - x0)[:, None].to(img.dtype)
    wy = (py - y0)[:, None].to(img.dtype)
    flat = img.reshape(b, c, h * w)

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        xi_c = torch.clamp(xi, 0, w - 1).long()
        yi_c = torch.clamp(yi, 0, h - 1).long()
        idx = (yi_c * w + xi_c).reshape(b, 1, -1).expand(b, c, -1)
        out = torch.gather(flat, 2, idx).reshape(b, c, *xi.shape[1:])
        return out * valid[:, None].to(img.dtype)

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    return v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy) + v10 * (1 - wx) * wy + v11 * wx * wy

"""ADA (Karras et al. 2020, arXiv:2006.06676) in plain `torch`: the
per-sample affine and colour matrices of the augmentation pipeline (xflip,
90-degree rotations, integer translation, isotropic scale, pre-rotation,
anisotropic scale, post-rotation, fractional translation; brightness,
contrast, luma flip, hue rotation, saturation), assembled from raw variates
and the probability p, and the adaptive-p update.

The variates are given (one dict of [B] tensors per draw, with `u` [8, B] /
[5, B] deciding which elementary transforms apply, u < p), so the reference
and the program consume the same numbers. Each transform that does not apply
is the identity.

Departure: the geometric resampling itself is implemented for the identity
only. A sample whose affine matrix is not the identity raises ValueError. The
benchmark compares the first training steps, where p is 0 (p moves only once
more than 256 real predictions are counted), so every matrix there is the
identity and the program's warp has to hand back its input unchanged.
"""

from __future__ import annotations

import math

import torch

LUMA = torch.tensor([1.0, 1.0, 1.0, 0.0]) / math.sqrt(3.0)


def _eye(b: int, n: int, device) -> torch.Tensor:
    return torch.eye(n, device=device).repeat(b, 1, 1)


def _mat2d(b, device, entries):
    m = _eye(b, 3, device)
    for (i, j), v in entries.items():
        m[:, i, j] = v
    return m


def _rotate(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    return _mat2d(theta.shape[0], theta.device, {(0, 0): c, (0, 1): -s, (1, 0): s, (1, 1): c})


def _scale(sx, sy):
    return _mat2d(sx.shape[0], sx.device, {(0, 0): sx, (1, 1): sy})


def _translate(tx, ty):
    return _mat2d(tx.shape[0], tx.device, {(0, 2): tx, (1, 2): ty})


def _maybe(u, p, mat, prev):
    """mat @ prev for the samples with u < p; prev for the others."""
    on = (u < p).float()[:, None, None]
    eye = torch.eye(mat.shape[-1], device=mat.device)
    return (on * mat + (1 - on) * eye) @ prev


def affine(d: dict, p: float, height: int, width: int) -> torch.Tensor:
    """[B, 3, 3] in normalised [-1, 1] coordinates."""
    b = d["t"].shape[0]
    dev = d["t"].device
    p_rot = 1.0 - math.sqrt(max(0.0, 1.0 - p))
    ln2 = math.log(2.0)
    G = _eye(b, 3, dev)
    G = _maybe(d["u"][0], p, _scale(1.0 - 2.0 * d["flip"], torch.ones_like(d["t"])), G)
    G = _maybe(d["u"][1], p, _rotate(-math.pi / 2 * d["quarter"]), G)
    G = _maybe(d["u"][2], p, _translate(torch.round(d["t"] * width) / width, torch.round(d["t"] * height) / height), G)
    s = torch.exp(d["s"] * 0.2 * ln2)
    G = _maybe(d["u"][3], p, _scale(s, s), G)
    G = _maybe(d["u"][4], p_rot, _rotate(-d["th_pre"]), G)
    s2 = torch.exp(d["s2"] * 0.2 * ln2)
    G = _maybe(d["u"][5], p, _scale(s2, 1.0 / s2), G)
    G = _maybe(d["u"][6], p_rot, _rotate(-d["th_post"]), G)
    return _maybe(d["u"][7], p, _translate(d["tf"] * 0.125, d["tf"] * 0.125), G)


def color(d: dict, p: float) -> torch.Tensor:
    """[B, 4, 4] in homogeneous RGB."""
    b = d["b"].shape[0]
    dev = d["b"].device
    axis = LUMA.to(dev)
    outer = torch.outer(axis, axis)
    C = _eye(b, 4, dev)
    t = _eye(b, 4, dev)
    t[:, :3, 3] = (d["b"] * 0.2)[:, None]
    C = _maybe(d["u"][0], p, t, C)
    sc = torch.exp(d["c"] * 0.5 * math.log(2.0))
    m = _eye(b, 4, dev)
    m[:, 0, 0] = m[:, 1, 1] = m[:, 2, 2] = sc
    C = _maybe(d["u"][1], p, m, C)
    C = _maybe(d["u"][2], p, _eye(b, 4, dev) - 2.0 * outer * d["lf"][:, None, None], C)
    u = axis[:3]
    cross = torch.tensor([[0.0, -u[2], u[1]], [u[2], 0.0, -u[0]], [-u[1], u[0], 0.0]], device=dev)
    cs, sn = torch.cos(d["hue"])[:, None, None], torch.sin(d["hue"])[:, None, None]
    rot = _eye(b, 4, dev)
    rot[:, :3, :3] = cs * torch.eye(3, device=dev) + sn * cross + (1 - cs) * torch.outer(u, u)
    C = _maybe(d["u"][3], p, rot, C)
    sat = torch.exp(d["sat"] * math.log(2.0))[:, None, None]
    return _maybe(d["u"][4], p, outer + (_eye(b, 4, dev) - outer) * sat, C)


def augment(img: torch.Tensor, p: float, draw: dict) -> torch.Tensor:
    """Geometric transform (identity only, see the module's note), then colour."""
    b, _, h, w = img.shape
    G = affine(draw["affine"], p, h, w)
    if not torch.equal(G, _eye(b, 3, img.device)):
        raise ValueError("the reference resamples identity transforms only (p > 0 at a compared step)")
    C = color(draw["color"], p)
    if torch.equal(C, _eye(b, 4, img.device)):
        return img
    return torch.einsum("bij,bjhw->bihw", C[:, :3, :3], img) + C[:, :3, 3][:, :, None, None]


def adjust_p(p: float, signs: float, n: float, target: float = 0.6, length: float = 15_000.0,
             threshold: float = 256.0) -> tuple[float, float, float]:
    """Once more than `threshold` real predictions are counted, step p by
    sign(r_t - target) * n * target / length (clamped to [0, 1]) and reset
    the counts. Returns (p, signs, n)."""
    if n <= threshold:
        return p, signs, n
    r_t = signs / n
    step = (1.0 if r_t > target else -1.0) * n * target / length
    return min(max(p + step, 0.0), 1.0), 0.0, 0.0

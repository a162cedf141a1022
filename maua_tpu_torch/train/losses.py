"""StyleGAN2 GAN losses and regularizers (counterpart of maua_tpu/train/losses.py).

  d_logistic_loss   = mean softplus(-real) + mean softplus(fake)
  g_nonsaturating   = mean softplus(-fake)
  d_r1_penalty      = 0.5 * mean over the batch of ||d sum D(x) / dx||^2
  path length reg   = mean (||J^T y|| - a)^2, a the running mean of the lengths

Both regularizers take a gradient with `create_graph=True`, so the caller can
differentiate them again with respect to the networks' parameters: the
double backward runs through the fused bias + leaky-ReLU gradient Function
(ops/fused_act.py).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

__all__ = ["d_logistic_loss", "d_r1_penalty", "g_nonsaturating_loss", "g_path_length_regularization"]


def d_logistic_loss(real_pred: torch.Tensor, fake_pred: torch.Tensor) -> torch.Tensor:
    """Non-saturating logistic D loss."""
    return F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()


def g_nonsaturating_loss(fake_pred: torch.Tensor) -> torch.Tensor:
    """Non-saturating G loss."""
    return F.softplus(-fake_pred).mean()


def d_r1_penalty(d_apply: Callable[[torch.Tensor], torch.Tensor], real_img: torch.Tensor) -> torch.Tensor:
    """R1: 0.5 * mean over the batch of the summed squared gradient of
    sum(D(x)) with respect to the real images; differentiable with respect to
    D's parameters."""
    real_img = real_img.detach().requires_grad_(True)
    (grad,) = torch.autograd.grad(d_apply(real_img).sum(), real_img, create_graph=True)
    return 0.5 * grad.square().reshape(grad.shape[0], -1).sum(dim=1).mean()


def g_path_length_regularization(
    g_apply: Callable[[torch.Tensor], torch.Tensor],
    latents: torch.Tensor,
    mean_path_length: torch.Tensor,
    noise_img: torch.Tensor,
    decay: float = 0.01,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Perceptual path length regularizer.

    g_apply: W+ latents [B, n_latent, D] -> image. `latents` must be part of
    the graph (a W+ mapped from z with gradients on, or a leaf that requires
    grad). `noise_img` is the unit normal draw of the image's shape; it is
    divided by sqrt(H*W) here. Returns (penalty, updated mean (detached),
    path_lengths)."""
    img = g_apply(latents)
    h, w = img.shape[-2:]
    proj = (img * (noise_img / math.sqrt(h * w))).sum()
    (grad,) = torch.autograd.grad(proj, latents, create_graph=True)
    path_lengths = grad.square().sum(dim=2).mean(dim=1).sqrt()
    path_mean = mean_path_length + decay * (path_lengths.mean() - mean_path_length)
    penalty = (path_lengths - path_mean).square().mean()
    path_mean = torch.where(torch.isnan(path_mean), mean_path_length, path_mean)
    penalty = torch.where(torch.isnan(penalty), torch.zeros_like(penalty), penalty)
    return penalty, path_mean.detach(), path_lengths

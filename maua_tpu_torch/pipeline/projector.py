"""GAN inversion: optimise a W+ latent and the per-layer noise maps to
reconstruct images (counterpart of maua_tpu/pipeline/projector.py).

A distance (LPIPS at 256^2, or by default the MSE of 64^2 resizes), the
multi-scale noise autocorrelation penalty and an optional pixel MSE; a cosine
ramp of the learning rate, latent noise annealed over the first 3/4 of the
steps, Adam, and the noise maps renormalised after every step. The forward
through the StyleGAN2 generator launches the fused bias + leaky-ReLU kernel
once per StyledConv and the backward its gradient kernel as often; the
mapping network does not run (the latent is already W+).

Draws, in order, from `draws` (`maua_tpu_torch.draws.Draws`): 10,000 z for
the latent statistics, one [B, 1, h, w] noise map per layer, then one
[B, n_latent, D] latent-noise draw per step.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..draws import Draws
from ..models import noise_shapes
from ..models.blocks import tf32
from ..ops.resize import resize_bilinear

__all__ = ["noise_normalize", "noise_regularize", "project", "projector_loss"]


def noise_regularize(noises: list[torch.Tensor]) -> torch.Tensor:
    """Squared mean autocorrelation of each noise map with itself shifted by
    one pixel along each axis, summed over 2x2-mean-pooled scales down to 8."""
    loss = torch.zeros((), device=noises[0].device)
    for n in noises:
        while True:
            size = n.shape[2]
            loss = loss + (n * torch.roll(n, 1, dims=3)).mean() ** 2
            loss = loss + (n * torch.roll(n, 1, dims=2)).mean() ** 2
            if size <= 8:
                break
            n = n.reshape(n.shape[0], 1, size // 2, 2, size // 2, 2).mean(dim=(3, 5))
    return loss


def noise_normalize(noises: list[torch.Tensor]) -> list[torch.Tensor]:
    """Each map to zero mean and unit population std (clamped at 1e-8)."""
    return [(n - n.mean()) / torch.clamp(n.std(correction=0), min=1e-8) for n in noises]


def _lr_schedule(step: int, n_steps: int, lr: float, rampdown: float = 0.25, rampup: float = 0.05) -> float:
    t = step / n_steps
    ramp = min(1.0, (1.0 - t) / rampdown)
    ramp = 0.5 - 0.5 * math.cos(ramp * math.pi)
    return lr * ramp * min(1.0, t / rampup)


def mse64(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-sample MSE of 64^2 bilinear resizes: the distance when no LPIPS is given."""
    a, t = resize_bilinear(img, (64, 64)), resize_bilinear(target, (64, 64))
    return (a - t).square().mean(dim=(1, 2, 3))


def projector_loss(
    gen,
    target: torch.Tensor,
    latent: torch.Tensor,
    noises: list[torch.Tensor],
    latent_draw: torch.Tensor,
    strength: float,
    distance_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = mse64,
    noise_regularize_weight: float = 1e5,
    mse_weight: float = 0.0,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One step's loss (distance + weighted noise penalty + weighted MSE)
    and (distance, noise penalty), differentiable in `latent` and `noises`."""
    img, _ = gen(latent + latent_draw * strength, input_is_latent=True, noise=noises, randomize_noise=False)
    d = distance_fn(img, target).mean()
    n_reg = noise_regularize(noises)
    mse = (img - target).square().mean()
    return d + noise_regularize_weight * n_reg + mse_weight * mse, (d, n_reg)


def project(
    gen,
    target: torch.Tensor,
    n_steps: int = 1000,
    lr: float = 0.1,
    latent_noise: float = 0.05,
    noise_regularize_weight: float = 1e5,
    mse_weight: float = 0.0,
    distance_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    draws=None,
    log_every: int = 0,
):
    """Invert `target` ([-1, 1] NCHW on the generator's device) through the
    StyleGAN2 `gen`; returns (latent W+ [B, L, D], noise maps, history).

    Adam with b1 0.9, b2 0.999, eps 1e-8 and a step count from 1, scaled by
    the scheduled learning rate (0 at step 0). `history` holds
    {step, loss, dist} every `log_every` steps, before that step's update.
    `draws` defaults to `Draws(0)` on the generator's device."""
    device = target.device
    draws = Draws(0, device) if draws is None else draws
    distance_fn = mse64 if distance_fn is None else distance_fn
    b = target.shape[0]
    with torch.no_grad():
        w = gen.get_latent(draws.normal(10_000, gen.style_dim).to(device))
        latent_mean = w.mean(dim=0)
        latent_std = float(torch.sqrt((w - latent_mean).square().sum(dim=1).mean()))
        del w
    latent = latent_mean[None, None].repeat(b, gen.n_latent, 1).clone().requires_grad_(True)
    noises = [draws.normal(b, *s[1:]).to(device).requires_grad_(True) for s in noise_shapes(gen.size)]
    params = [latent, *noises]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    b1, b2, eps = 0.9, 0.999, 1e-8

    history = []
    for i in range(n_steps):
        t = i / n_steps
        strength = latent_std * latent_noise * max(0.0, 1.0 - t / 0.75) ** 2
        latent_draw = draws.normal(b, gen.n_latent, gen.style_dim).to(device)
        with tf32(conv=False, matmul=False):
            loss, (d, _) = projector_loss(gen, target, latent, noises, latent_draw, strength, distance_fn,
                                          noise_regularize_weight, mse_weight)
            grads = torch.autograd.grad(loss, params)
        loss, d = loss.detach(), d.detach()
        if log_every and i % log_every == 0:
            history.append({"step": i, "loss": loss.item(), "dist": d.item()})
        cur_lr = _lr_schedule(i, n_steps, lr)
        with torch.no_grad():
            for p, g, mi, vi in zip(params, grads, m, v):
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = mi / (1 - b1 ** (i + 1))
                v_hat = vi / (1 - b2 ** (i + 1))
                p.sub_(cur_lr * m_hat / (torch.sqrt(v_hat) + eps))
            for n, normed in zip(noises, noise_normalize(noises)):
                n.copy_(normed)
    return latent.detach(), [n.detach() for n in noises], history

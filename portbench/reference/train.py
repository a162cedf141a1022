"""The first steps of StyleGAN2 training with ADA, in plain fp32 `torch`,
after rosinality's stylegan2-pytorch `train.py`: the non-saturating logistic
losses, lazy R1 on raw reals, the lazy path-length penalty with its running
mean, the adaptive-p update, Adam with the lazy-regularization ratio, the
lookahead-minimax cache and the generator EMA.

Inputs are given: the initial weights (rosinality-keyed dicts), the real
batches, and every random variate of each step (latents, mixing, noise, ADA's
variates, the path penalty's image noise), as plain dicts of tensors. The
step's order is rosinality's: D step, R1 D step (every d_reg_every), p
update, G step, path G step (every g_reg_every), lookahead, EMA.

Departures from the reference repository, each on purpose:
* style mixing per sample (each sample's own mix flag and inject index);
* R1's weight is r1 x size^2 (the train CLI's convention), the path penalty
  runs on `len(path draws)` chunks of fresh latents with the running mean
  threaded through them (the CLI's `reg_chunks` estimator);
* the optimizers' betas are (0, 0.99) raised to the lazy ratio, both lr's
  scaled by it (rosinality scales beta1 = 0 the same way);
* ADA is ADA's own (reference/ada.py), with the identity-only resampling.
Every pass through D runs on blocks of whole minibatch-stddev groups (the
statistic of group j is over samples j, j + B/4, j + B/2, j + 3B/4), which
is the whole batch's D exactly and keeps the memory of one block.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import ada
from .stylegan2 import discriminator, mapping, n_latent, synthesis

STDDEV_GROUP = 4
EMA_DECAY = 0.5 ** (32 / 10_000)


def group_blocks(n: int, group: int = STDDEV_GROUP) -> list[torch.Tensor]:
    """Index blocks of whole minibatch-stddev groups of a batch of n."""
    g = min(n, group)
    stride = n // g
    return [j + stride * torch.arange(g) for j in range(stride)]


class Adam:
    """torch.optim.Adam's arithmetic, written out."""

    def __init__(self, params: dict, lr: float, betas: tuple[float, float], eps: float = 1e-8):
        self.lr, self.betas, self.eps, self.t = lr, betas, eps, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        b1, b2 = self.betas
        self.t += 1
        c1, c2 = 1 - b1**self.t, 1 - b2**self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            p -= (self.lr / c1) * self.m[k] / (self.v[k].sqrt() / math.sqrt(c2) + self.eps)


def lazy_adam(params: dict, lr: float, reg_every: int) -> Adam:
    r = reg_every / (reg_every + 1)
    return Adam(params, lr * r, (0.0**r, 0.99**r))


def leaves(p: dict) -> dict:
    """The trainable tensors of a rosinality dict (no FIR kernels, no noise buffers)."""
    return {k: v for k, v in p.items() if not k.endswith(".kernel") and not k.startswith("noises.")}


def wplus(pg: dict, draw: dict, size: int) -> torch.Tensor:
    n = n_latent(size)
    w1, w2 = mapping(pg, draw["z1"]), mapping(pg, draw["z2"])
    inject = torch.where(draw["mix"], draw["inject"], torch.full_like(draw["inject"], n))
    take_w2 = torch.arange(n, device=w1.device)[None, :, None] >= inject[:, None, None]
    return torch.where(take_w2, w2[:, None, :], w1[:, None, :])


def rows(draw: dict, idx: torch.Tensor) -> dict:
    """The rows idx of every per-sample tensor of a draw."""
    out = {}
    for k, v in draw.items():
        if k == "noise":
            out[k] = [n[idx] for n in v]
        elif isinstance(v, torch.Tensor):
            out[k] = v[idx]
    return out


def aug_rows(aug: dict, idx: torch.Tensor) -> dict:
    """Rows idx of an augmentation draw (a variate's last axis is the batch)."""
    return {part: {k: v[..., idx] for k, v in aug[part].items()} for part in ("affine", "color")}


def _grad(loss: torch.Tensor, params: dict, acc: Optional[dict]) -> dict:
    keys = list(params)
    gs = torch.autograd.grad(loss, [params[k] for k in keys], allow_unused=True)
    gs = {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(keys, gs)}
    return gs if acc is None else {k: acc[k] + gs[k] for k in keys}


def train(g0: dict, d0: dict, cfg: dict, reals: list[torch.Tensor], draws: list[dict],
          fault: Optional[str] = None) -> dict:
    """Follow len(reals) steps from step 0. reals: per step [B, 3, H, W] in
    [-1, 1]; draws: per step {"d": [MixDraw dict], "g": [...], "path": [...]}
    (one microbatch a step).
    cfg: size, batch, lr, r1, path_regularize, d_reg_every, g_reg_every,
    ada_target, ada_length, la_steps, la_alpha, augment_p.
    Returns per-step losses, each optimizer's first gradient (per leaf) and
    the final g, d and g_ema weights. `fault` plants a known defect (for the
    checks of the comparison): "half_batch" leaves out the second half of
    every batch and takes each mean over the rest."""
    size = cfg["size"]
    pg = {k: v.detach().clone().requires_grad_(k in leaves(g0)) for k, v in g0.items()}
    pd = {k: v.detach().clone().requires_grad_(k in leaves(d0)) for k, v in d0.items()}
    tg, td = leaves(pg), leaves(pd)
    g_ema = {k: v.detach().clone() for k, v in tg.items()}
    slow_g = {k: v.detach().clone() for k, v in tg.items()}
    slow_d = {k: v.detach().clone() for k, v in td.items()}
    g_opt = lazy_adam(tg, cfg["lr"], cfg["g_reg_every"])
    d_opt = lazy_adam(td, cfg["lr"], cfg["d_reg_every"])
    mpl = torch.zeros((), device=reals[0].device)
    p, signs, n_pred, la_step = float(cfg["augment_p"]), 0.0, 0.0, 0
    losses, first = [], {}

    def gen(w, noise):
        return synthesis(pg, w, noise, size)

    def disc(x):
        return discriminator(pd, x, size)

    for step, (real, dr) in enumerate(zip(reals, draws)):
        b = real.shape[0]
        wt = torch.full((b,), 1.0 / b, device=real.device)  # each sample's share of a batch mean
        if fault == "half_batch":
            wt[: b // 2], wt[b // 2:] = 2.0 / b, 0.0
        rec = {}
        # ---- D step: fakes without gradient, D on augmented fakes and reals ----
        dd = dr["d"][0]  # one microbatch a step (num_accumulate 1)
        augs = dd["aug"]
        grads, dl, sign_sum = None, 0.0, 0.0
        for idx in group_blocks(b):
            sub = rows(dd, idx)
            with torch.no_grad():
                fake = gen(wplus(pg, sub, size), sub["noise"])
            if len(augs) == 1:  # one draw for the interleaved [f0, r0, f1, r1, ...] batch
                fa, ra = aug_rows(augs[0], 2 * idx), aug_rows(augs[0], 2 * idx + 1)
            else:
                fa, ra = aug_rows(augs[0], idx), aug_rows(augs[1], idx)
            fake_pred = disc(ada.augment(fake, p, fa))
            real_pred = disc(ada.augment(real[idx], p, ra))
            part = ((F.softplus(-real_pred) + F.softplus(fake_pred)).flatten() * wt[idx]).sum()
            grads = _grad(part, td, grads)
            dl += float(part.detach())
            sign_sum += float(torch.sign(real_pred.detach()).sum())
        rec["Discriminator"] = dl
        first.setdefault("d", grads)
        d_opt.step(td, grads)
        # ---- R1 on raw reals ----
        if step % cfg["d_reg_every"] == 0:
            grads, r1 = None, 0.0
            for idx in group_blocks(b):
                x = real[idx].detach().requires_grad_(True)
                (gx,) = torch.autograd.grad(disc(x).sum(), x, create_graph=True)
                part = 0.5 * (gx.square().reshape(len(idx), -1).sum(1) * wt[idx]).sum()
                grads = _grad(cfg["r1"] * cfg["d_reg_every"] * part, td, grads)
                r1 += float(part.detach())
            rec["R1 Penalty"] = r1
            d_opt.step(td, grads)
        # ---- adaptive p ----
        if cfg["augment_p"] == 0:
            p, signs, n_pred = ada.adjust_p(p, signs + sign_sum, n_pred + b, cfg["ada_target"], cfg["ada_length"])
        # ---- G step ----
        gd = dr["g"][0]
        grads, gl = None, 0.0
        for idx in group_blocks(b):
            sub = rows(gd, idx)
            fake = gen(wplus(pg, sub, size), sub["noise"])
            pred = disc(ada.augment(fake, p, aug_rows(gd["aug"][0], idx)))
            part = (F.softplus(-pred).flatten() * wt[idx]).sum()
            grads = _grad(part, tg, grads)
            gl += float(part.detach())
        rec["Generator"] = gl
        first.setdefault("g", grads)
        g_opt.step(tg, grads)
        # ---- path-length penalty, chunk by chunk, the running mean threaded through ----
        if step % cfg["g_reg_every"] == 0:
            grads, pen = None, 0.0
            k = len(dr["path"])
            for pdraw in dr["path"]:
                if fault == "half_batch" and pdraw["z1"].shape[0] > 1:
                    pdraw = {**rows(pdraw, torch.arange(pdraw["z1"].shape[0] // 2)), "noise": [
                        n[: pdraw["z1"].shape[0] // 2] for n in pdraw["noise"]]}
                w = wplus(pg, pdraw, size)
                img = gen(w, pdraw["noise"])
                h, wd = img.shape[-2:]
                (gw,) = torch.autograd.grad((img * pdraw["img_noise"] / math.sqrt(h * wd)).sum(), w,
                                            create_graph=True)
                lengths = gw.square().sum(2).mean(1).sqrt()
                path_mean = mpl + 0.01 * (lengths.mean() - mpl)
                penalty = (lengths - path_mean).square().mean()
                grads = _grad(cfg["path_regularize"] * cfg["g_reg_every"] * penalty / k, tg, grads)
                pen += float(penalty.detach()) / k
                mpl = path_mean.detach()
            rec["Path Length Regularization"] = pen
            g_opt.step(tg, grads)
        # ---- lookahead-minimax, EMA ----
        with torch.no_grad():
            la_step += 1
            if la_step % cfg["la_steps"] == 0:
                for slow, fast in ((slow_g, tg), (slow_d, td)):
                    for key in slow:
                        slow[key] += cfg["la_alpha"] * (fast[key] - slow[key])
                        fast[key].copy_(slow[key])
            for key, v in tg.items():
                g_ema[key] = EMA_DECAY * g_ema[key] + (1 - EMA_DECAY) * v
        losses.append(rec)
    return {"losses": losses, "first_grads": first,
            "g": {k: v.detach() for k, v in tg.items()}, "d": {k: v.detach() for k, v in td.items()},
            "g_ema": g_ema, "p": p}


def as_reals(u8: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, 3, H, W] fp32 in [-1, 1]."""
    return u8.permute(0, 3, 1, 2).float() / 127.5 - 1.0


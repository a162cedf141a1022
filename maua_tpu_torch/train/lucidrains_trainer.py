"""Trainer for the lucidrains alternative StyleGAN2 in PyTorch (counterpart of
maua_tpu/train/lucidrains_trainer.py).

* One iteration: D's hinge + quantize loss with the lazy gradient penalty,
  then G's hinge loss with the lazy path penalty against the updated D, then
  the EMA / reset schedule. The lazy phases are host-side `if`s on the step
  counter where the JAX package uses `lax.cond`: the gradient penalty every
  `gp_every` steps, the path penalty every `pl_every`, the EMA every
  `ema_every` past `ema_start`, the hard reset of the EMA copies at
  `step % 1000 == 2` up to `reset_ema_until`.
* DiffGrad (`DiffGrad`, made by `diffgrad`) is a `torch.optim.Optimizer` with
  the JAX package's arithmetic: bias-corrected Adam moments, the first one
  times sigmoid(|previous gradient - gradient|), the previous gradient
  starting at zero. S and G share one DiffGrad.
* Gradient accumulation is a Python loop over the leading microbatch axis of
  `real` [accum, B, C, S, S]; each microbatch's loss is divided by accum and
  the gradients summed.
* Every random draw of a step comes from `draw_lucidrains_step` (a
  `torch.Generator` on the device), kept apart from the arithmetic, so that a
  test can hand the step JAX's draws.
* NaN recovery: when a step's metrics come back non-finite, the trainer
  restores the last checkpoint (or, when there is none yet, the state from
  before the step) and raises NanException, for the caller's retry loop.

Checkpoints are `model_{num}.pt`, a `torch.save` of the whole state (S, G,
D, the EMA copies, both optimizers, pl_mean, the step), where the JAX
package writes flax msgpack.
"""

from __future__ import annotations

import copy
import glob
import math
import os
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..draws import Draws
from ..models.blocks import tf32
from ..models.lucidrains import (
    LucidrainsDiscriminator,
    LucidrainsGenerator,
    StyleDraw,
    StyleVectorizer,
    draw_styles,
    gradient_penalty,
    hinge_d_loss,
    mixed_styles,
)
from .step import _add_grads

EPS = 1e-8

__all__ = [
    "DiffGrad",
    "LucidrainsConfig",
    "LucidrainsDraw",
    "LucidrainsStepDraws",
    "LucidrainsTrainState",
    "LucidrainsTrainer",
    "NanException",
    "diffgrad",
    "draw_lucidrains_step",
    "init_lucidrains_state",
    "make_lucidrains_train_step",
]


class NanException(Exception):
    """A training step came back with a non-finite loss."""


class DiffGrad(torch.optim.Optimizer):
    """Adam with a per-element friction sigmoid(|g_prev - g|) on the first
    moment: elements whose gradient changes slowly take damped steps.
    update = -lr * (m_hat * sigmoid(|g_prev - g|)) / (sqrt(v_hat) + eps)."""

    def __init__(self, params, lr: float, betas: tuple[float, float] = (0.5, 0.9), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            lr, (b1, b2), eps = group["lr"], group["betas"], group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    for k in ("mu", "nu", "prev_grad"):
                        st[k] = torch.zeros_like(p)
                st["step"] += 1
                # the bias corrections in fp32, as the JAX package computes them
                bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(st["step"]))
                bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(st["step"]))
                st["mu"] = b1 * st["mu"] + (1 - b1) * g
                st["nu"] = b2 * st["nu"] + (1 - b2) * g * g
                dfc = torch.sigmoid((st["prev_grad"] - g).abs())
                p.add_(-lr * (st["mu"] / bc1 * dfc) / ((st["nu"] / bc2).sqrt() + eps))
                st["prev_grad"] = g.clone()


def diffgrad(params, learning_rate: float, b1: float = 0.5, b2: float = 0.9, eps: float = 1e-8) -> DiffGrad:
    """DiffGrad over `params` (the reference builds both optimizers with
    betas (0.5, 0.9))."""
    return DiffGrad(params, learning_rate, (b1, b2), eps)


class LucidrainsConfig(NamedTuple):
    """The reference Trainer's arguments, with the JAX package's defaults."""

    image_size: int = 128
    latent_dim: int = 512
    style_depth: int = 8
    network_capacity: int = 16
    transparent: bool = False
    batch_size: int = 4
    gradient_accumulate_every: int = 1
    lr: float = 2e-4
    mixed_prob: float = 0.9
    gp_every: int = 4  # the gradient penalty at steps % 4 == 0
    pl_every: int = 32  # the path penalty at steps % 32 == 0
    ema_beta: float = 0.995
    ema_every: int = 10  # the EMA every 10 steps ...
    ema_start: int = 20_000  # ... past 20k
    reset_ema_until: int = 25_000  # the EMA copies reset at step % 1000 == 2 up to here
    pl_decay: float = 0.99
    fq_layers: tuple = ()
    fq_dict_size: int = 256
    attn_layers: tuple = ()


@dataclass
class LucidrainsTrainState:
    step: int
    s: StyleVectorizer
    g: LucidrainsGenerator
    d: LucidrainsDiscriminator
    se: StyleVectorizer  # the EMA copies of S and G
    ge: LucidrainsGenerator
    g_opt: DiffGrad  # one DiffGrad over S's and G's parameters
    d_opt: DiffGrad
    pl_mean: torch.Tensor  # 0-d fp32 on the device

    @property
    def device(self) -> torch.device:
        return self.pl_mean.device

    def state_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {k: getattr(self, k).state_dict() for k in ("s", "g", "d", "se", "ge", "g_opt", "d_opt")}
        return {**out, "step": self.step, "pl_mean": self.pl_mean}

    def load_state_dict(self, sd: dict[str, Any]) -> None:
        for k in ("s", "g", "d", "se", "ge", "g_opt", "d_opt"):
            getattr(self, k).load_state_dict(sd[k])
        self.step = int(sd["step"])
        self.pl_mean = sd["pl_mean"].to(self.device, torch.float32).clone()


def _models(cfg: LucidrainsConfig):
    s = StyleVectorizer(emb=cfg.latent_dim, depth=cfg.style_depth)
    g = LucidrainsGenerator(image_size=cfg.image_size, latent_dim=cfg.latent_dim,
                            network_capacity=cfg.network_capacity, transparent=cfg.transparent,
                            attn_layers=cfg.attn_layers)
    d = LucidrainsDiscriminator(image_size=cfg.image_size, network_capacity=cfg.network_capacity,
                                fq_layers=cfg.fq_layers, fq_dict_size=cfg.fq_dict_size,
                                attn_layers=cfg.attn_layers, transparent=cfg.transparent)
    return s, g, d


def _frozen_copy(m: torch.nn.Module) -> torch.nn.Module:
    return copy.deepcopy(m).requires_grad_(False)


def init_lucidrains_state(cfg: LucidrainsConfig, seed: int = 0, device: DeviceLike = None) -> LucidrainsTrainState:
    """S, G, D, their EMA copies (equal to S and G, the reference's reset at
    init) and the two DiffGrads on `device` (default `cuda`; RuntimeError
    without a card). Weights come from the CPU generator seeded with `seed`,
    without touching the global RNG."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        s, g, d = (m.to(device) for m in _models(cfg))
    return LucidrainsTrainState(
        step=0, s=s, g=g, d=d, se=_frozen_copy(s), ge=_frozen_copy(g),
        g_opt=diffgrad(list(s.parameters()) + list(g.parameters()), cfg.lr),
        d_opt=diffgrad(list(d.parameters()), cfg.lr),
        pl_mean=torch.zeros((), device=device),
    )


class LucidrainsDraw(NamedTuple):
    """The draws of one microbatch of a phase: the style mix, the image noise
    [B, S, S, 1] (U[0, 1)) and, in the G phase of a step with the path
    penalty due, the W perturbation [B, num_layers, latent_dim] (N(0, 1))."""

    style: StyleDraw
    noise: torch.Tensor
    pl: Optional[torch.Tensor] = None


class LucidrainsStepDraws(NamedTuple):
    d: list  # one LucidrainsDraw per microbatch
    g: list


def _num_layers(cfg: LucidrainsConfig) -> int:
    return int(math.log2(cfg.image_size) - 1)


def draw_lucidrains_step(cfg: LucidrainsConfig, step: int, generator: torch.Generator,
                         device: DeviceLike = None) -> LucidrainsStepDraws:
    """Every random draw of step `step` from `generator` (a torch.Generator
    on `device`), in the order D's microbatches, then G's."""
    device = resolve_device(device)
    n, b, size = _num_layers(cfg), cfg.batch_size, cfg.image_size

    def one(with_pl: bool) -> LucidrainsDraw:
        style = draw_styles(generator, b, n, cfg.latent_dim, cfg.mixed_prob, device)
        noise = torch.rand((b, size, size, 1), generator=generator, device=device)
        pl = torch.randn((b, n, cfg.latent_dim), generator=generator, device=device) if with_pl else None
        return LucidrainsDraw(style, noise, pl)

    acc = cfg.gradient_accumulate_every
    d = [one(False) for _ in range(acc)]
    return LucidrainsStepDraws(d=d, g=[one(step % cfg.pl_every == 0) for _ in range(acc)])


def _apply(optim: torch.optim.Optimizer, params: list, grads: list) -> None:
    for p, gr in zip(params, grads):
        p.grad = gr
    optim.step()
    for p in params:
        p.grad = None


@torch.no_grad()
def _ema(ema: torch.nn.Module, cur: torch.nn.Module, beta: float) -> None:
    for e, c in zip(ema.parameters(), cur.parameters()):
        e.copy_(beta * e + (1 - beta) * c)


@torch.no_grad()
def _reset(ema: torch.nn.Module, cur: torch.nn.Module) -> None:
    for e, c in zip(ema.parameters(), cur.parameters()):
        e.copy_(c)


def make_lucidrains_train_step(cfg: LucidrainsConfig):
    """train_step(state, real [accum, B, C, S, S] in [-1, 1], draws) ->
    metrics (0-d tensors); updates `state` in place."""
    n_layers = _num_layers(cfg)
    acc = cfg.gradient_accumulate_every

    def w_of(s, style: StyleDraw) -> torch.Tensor:
        return mixed_styles(style, s, cfg.batch_size, n_layers, cfg.latent_dim, cfg.mixed_prob)

    def train_step(state: LucidrainsTrainState, real: torch.Tensor, draws: LucidrainsStepDraws) -> dict:
        if real.ndim != 5 or real.shape[0] != acc or real.shape[1] != cfg.batch_size:
            raise ValueError(f"real must be [{acc}, {cfg.batch_size}, C, S, S], got {list(real.shape)}")
        apply_gp = state.step % cfg.gp_every == 0
        apply_pl = state.step % cfg.pl_every == 0
        real = real.to(state.device, torch.float32)
        zero = torch.zeros((), device=state.device)
        m = dict.fromkeys(("Discriminator", "Quantize", "R1", "Generator", "Path Length"), zero)
        with tf32(conv=False, matmul=False):
            # D (the fakes without a gradient)
            d_params = list(state.d.parameters())
            d_grads = None
            for a in range(acc):
                dr = draws.d[a]
                with torch.no_grad():
                    fake = state.g(w_of(state.s, dr.style), dr.noise)
                fake_out, fake_q = state.d(fake)
                real_out, real_q = state.d(real[a])
                divergence = hinge_d_loss(real_out, fake_out)
                quantize = fake_q + real_q
                gp = gradient_penalty(state.d, real[a]) if apply_gp else zero
                d_grads = _add_grads(d_params, (divergence + quantize + gp) / acc, d_grads)
                m["Discriminator"] = m["Discriminator"] + divergence.detach()
                m["Quantize"] = m["Quantize"] + quantize.detach()
                m["R1"] = m["R1"] + gp.detach()
            _apply(state.d_opt, d_params, d_grads)

            # G, against the updated D
            sg_params = list(state.s.parameters()) + list(state.g.parameters())
            sg_grads, avg_pl = None, zero
            for a in range(acc):
                dr = draws.g[a]
                w = w_of(state.s, dr.style)
                fake = state.g(w, dr.noise)
                fake_out, _ = state.d(fake)
                gen_loss = fake_out.mean()  # the hinge G loss
                pl_loss = zero
                if apply_pl:
                    # perturb W by noise scaled to its batch std (population std, as jnp.std)
                    std = 0.1 / (w.std(dim=0, keepdim=True, correction=0) + EPS)
                    pl_images = state.g(w + dr.pl / (std + EPS), dr.noise)
                    pl_lengths = (pl_images - fake).square().mean(dim=(1, 2, 3))
                    pl_loss = (pl_lengths - state.pl_mean).square().mean()
                    pl_loss = torch.where(torch.isnan(pl_loss), zero, pl_loss)
                    avg_pl = avg_pl + pl_lengths.mean().detach()
                sg_grads = _add_grads(sg_params, (gen_loss + pl_loss) / acc, sg_grads)
                m["Generator"] = m["Generator"] + gen_loss.detach()
                m["Path Length"] = m["Path Length"] + pl_loss.detach()
            _apply(state.g_opt, sg_params, sg_grads)

        if apply_pl:
            new_pl = cfg.pl_decay * state.pl_mean + (1 - cfg.pl_decay) * (avg_pl / acc)
            state.pl_mean = torch.where(torch.isnan(new_pl), state.pl_mean, new_pl)
        if state.step <= cfg.reset_ema_until and state.step % 1000 == 2:
            _reset(state.se, state.s)
            _reset(state.ge, state.g)
        elif state.step % cfg.ema_every == 0 and state.step > cfg.ema_start:
            _ema(state.se, state.s, cfg.ema_beta)
            _ema(state.ge, state.g, cfg.ema_beta)
        state.step += 1
        return {**{k: v / acc for k, v in m.items()}, "Mean Path Length": state.pl_mean}

    return train_step


class LucidrainsTrainer:
    """Host loop around the step: draws, checkpoints, NaN recovery, sampling.

    On a non-finite metric the trainer restores the most recent checkpoint
    (`step // save_every`) and raises NanException; callers wrap `.train()`
    in a retry loop, as the reference's `retry_call(self.train, tries=3,
    exceptions=NanException)` does. So that such a checkpoint always exists,
    a step whose checkpoint is missing (the first interval of a run) saves
    the state before it: `model_0.pt` holds the initial state. (The JAX
    package keeps the pre-step state there, which its functional update gives
    for free; the port would need a copy of the whole state on every step of
    the interval.) Runs on `device` (default `cuda`; RuntimeError without a
    card)."""

    def __init__(self, cfg: LucidrainsConfig, models_dir: str = "models", name: str = "default",
                 save_every: int = 1000, seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.name = name
        self.models_dir = os.path.join(models_dir, name)
        os.makedirs(self.models_dir, exist_ok=True)
        self.save_every = save_every
        self.state = init_lucidrains_state(cfg, seed, self.device)
        self.step_fn = make_lucidrains_train_step(cfg)
        self.draws = Draws(seed + 1, self.device)  # the step draws come from its generator
        self.last_metrics: dict[str, float] = {}

    def _ckpt_path(self, num: int) -> str:
        return os.path.join(self.models_dir, f"model_{num}.pt")

    def save(self, num: Optional[int] = None) -> str:
        num = self.state.step // self.save_every if num is None else num
        path = self._ckpt_path(num)
        torch.save(self.state.state_dict(), path)
        return path

    def load(self, num: int = -1) -> None:
        if num == -1:
            paths = glob.glob(os.path.join(self.models_dir, "model_*.pt"))
            if not paths:
                raise FileNotFoundError(f"no checkpoints under {self.models_dir}")
            num = max(int(os.path.basename(p).split("_")[1].split(".")[0]) for p in paths)
        self.state.load_state_dict(torch.load(self._ckpt_path(num), map_location=self.device, weights_only=True))

    def train(self, real) -> dict[str, float]:
        """real: [gradient_accumulate_every, batch, C, S, S] in [-1, 1] (a
        tensor or an array). Raises NanException (after the restore) on a
        non-finite metric."""
        real = torch.as_tensor(real).to(self.device, torch.float32)
        step = self.state.step
        draws = draw_lucidrains_step(self.cfg, step, self.draws.gen, self.device)
        ckpt = step // self.save_every
        if not os.path.exists(self._ckpt_path(ckpt)):
            self.save(ckpt)
        out = self.step_fn(self.state, real, draws)
        values = torch.stack([v.float() for v in out.values()]).tolist()  # one copy to the host
        metrics = dict(zip(out, values))
        if not all(math.isfinite(v) for v in values):
            self.load(ckpt)
            raise NanException(f"NaN detected at step {step}: {metrics}")
        self.last_metrics = metrics
        if self.state.step % self.save_every == 0:
            self.save()
        return metrics

    @torch.no_grad()
    def generate(self, n: int = 8, use_ema: bool = True, trunc_psi: float = 0.6, draws: Any = None) -> np.ndarray:
        """n images [n, C, S, S] (fp32, numpy), W truncated by `trunc_psi`
        toward the mean W of 2000 draws. `draws` (a `Draws`-like object; the
        trainer's own by default) gives z [n, latent], the mean's z [2000,
        latent] and the noise [n, S, S, 1], in that order."""
        draws = self.draws if draws is None else draws
        s = self.state.se if use_ema else self.state.s
        g = self.state.ge if use_ema else self.state.g
        cfg = self.cfg
        z = draws.normal(n, cfg.latent_dim).to(self.device)
        z_mean = draws.normal(2000, cfg.latent_dim).to(self.device)
        noise = draws.uniform(n, cfg.image_size, cfg.image_size, 1).to(self.device)
        with tf32(conv=False, matmul=False):
            w = s(z)
            w_mean = s(z_mean).mean(dim=0)
            w = w_mean + trunc_psi * (w - w_mean)
            img = g(w[:, None].repeat(1, _num_layers(cfg), 1), noise)
        return img.float().cpu().numpy()


"""The StyleGAN2 train step: D phase, lazy R1, G phase, lazy path-length
regularization, lookahead-minimax and EMA (counterpart of
maua_tpu/train/step.py).

The JAX step is one jitted pure function of (state, batch, rng). Here the
state holds the modules and optimizers and the phases update it in place:

* `init_train_state(cfg, seed, device)` builds G, D, the EMA copy of G, one
  Adam for each network with the lazy-regularization ratio (lr * r, betas
  0**r and 0.99**r, r = n / (n + 1)), the lookahead cache and the running
  path-length mean. R1 steps D's optimizer and the path penalty G's, as in
  the JAX package.
* Every random draw of a step is made up front by `draw_step` from one
  `torch.Generator`: z1, z2, the mixing mask and inject index, the per-layer
  noise and the path-length image noise. The step consumes them, so a test
  can hand both packages the same draws, and a rematerialised synthesis
  (`torch.utils.checkpoint`, which restores only the global RNG) sees the
  same noise when it runs again.
* `make_train_phases(cfg)` returns the phases `d`, `r1`, `g`, `path` and
  `tail`; `make_train_step(cfg)` composes them in the JAX order. Each of
  `d`, `r1`, `g` and `path` returns (aux, grads) after its optimizer step,
  grads in the order of the network's `parameters()`.
* Each phase holds TF32 off (`tf32(False, False)`) over its forward and its
  backward: cuDNN's default would run the backward convs in TF32.

Exact options: gradient accumulation over `num_accumulate` microbatches,
`reg_chunks` for R1 (sequential strided chunks, guarded so that a chunk keeps
whole minibatch-stddev groups) and `remat_synth` (activation checkpointing of
G's synthesis in the G phase). The path penalty in `reg_chunks` chunks draws
fresh latents for each chunk, as the JAX package does: the same estimator,
not the same numbers. ADA (`augment`), bCR and the
contrastive regularizer are not ported yet (ROADMAP item 11, Queue 2c) and
raise; `s2d_min_res` and `fast_phase_noise` are TPU layouts and are ignored.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..models import Discriminator, Generator
from ..models.blocks import tf32
from ..models.stylegan2 import noise_shapes
from .ema import EMA_DECAY_DEFAULT, ema_update
from .lookahead import LookaheadState, lookahead_minimax_init, lookahead_minimax_step
from .losses import d_logistic_loss, d_r1_penalty, g_nonsaturating_loss, g_path_length_regularization

__all__ = [
    "MixDraw",
    "PathDraw",
    "StepDraws",
    "TrainConfig",
    "TrainState",
    "draw_step",
    "init_train_state",
    "make_train_config",
    "make_train_phases",
    "make_train_step",
    "reg_adjusted_adam",
]


class TrainConfig(NamedTuple):
    """Training hyper-parameters: the fields and defaults of the JAX package's
    TrainConfig (maua_tpu/train/step.py:40-114), less the ADA and contrastive
    settings, which come with those features."""

    size: int = 256
    latent_dim: int = 512
    batch_size: int = 8  # batch per microbatch
    num_accumulate: int = 1
    lr: float = 2e-3
    r1: float = 1e-5  # scaled by size^2 in make_train_config
    path_regularize: float = 2.0
    path_batch_shrink: int = 2
    d_reg_every: int = 16
    g_reg_every: int = 4
    mixing_prob: float = 0.9
    channel_multiplier: int = 2
    channel_max: int = 512
    constant_input: bool = False
    augment: bool = True  # ADA: not ported yet, must be False
    augment_p: float = 0.0
    lookahead: bool = True
    la_steps: int = 500
    la_alpha: float = 0.5
    ema_decay: float = EMA_DECAY_DEFAULT
    bcr_weight: float = 0.0  # not ported yet, must be 0
    contrastive_weight: float = 0.0  # not ported yet, must be 0
    bf16: bool = False  # bf16 convs in G synthesis and D (parameters stay fp32)
    s2d_min_res: int = -1  # TPU layout: ignored
    fast_phase_noise: bool = True  # TPU layout: ignored
    reg_chunks: int = 1
    remat_synth: bool = False


def make_train_config(**kwargs) -> TrainConfig:
    """TrainConfig with the derived arguments: r1 *= size^2; bCR and the
    contrastive regularizer force augmentation on."""
    cfg = TrainConfig(**kwargs)
    if cfg.bcr_weight > 0 or cfg.contrastive_weight > 0:
        cfg = cfg._replace(augment=True)
    return cfg._replace(r1=cfg.r1 * cfg.size**2)


def _check_supported(cfg: TrainConfig) -> None:
    if cfg.augment:
        raise NotImplementedError(
            "ADA augmentation is not ported to maua_tpu_torch yet (ROADMAP item 11: "
            "train/augment.py and train/fft_warp.py, Queue 2c); train with augment=False "
            "(--no-augment)"
        )
    if cfg.bcr_weight > 0 or cfg.contrastive_weight > 0:
        raise NotImplementedError(
            "balanced consistency and contrastive regularization are not ported to "
            "maua_tpu_torch yet (ROADMAP item 11, with ADA)"
        )


def reg_adjusted_adam(params, lr: float, reg_every: int) -> torch.optim.Adam:
    """Adam with the lazy-regularization ratio r = n / (n + 1): lr * r,
    betas (0**r, 0.99**r), eps 1e-8 (maua_tpu/train/step.py:127-131)."""
    ratio = reg_every / (reg_every + 1.0)
    return torch.optim.Adam(params, lr=lr * ratio, betas=(0.0**ratio, 0.99**ratio), eps=1e-8)


@dataclass
class TrainState:
    step: int
    g: Generator
    d: Discriminator
    g_ema: Generator
    g_optim: torch.optim.Adam
    d_optim: torch.optim.Adam
    lookahead: Optional[LookaheadState]
    mean_path_length: torch.Tensor  # 0-d fp32 on the device
    ada_p: float = 0.0

    @property
    def device(self) -> torch.device:
        return self.mean_path_length.device


def init_train_state(cfg: TrainConfig, seed: int = 0, device: DeviceLike = None) -> TrainState:
    """Models, optimizers and the rest of the state, on `device` (default
    `cuda`; raises RuntimeError without a card). Weights are drawn from the
    CPU generator seeded with `seed`, without touching the global RNG."""
    device = resolve_device(device)
    _check_supported(cfg)
    dtype = torch.bfloat16 if cfg.bf16 else torch.float32
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        g = Generator(
            size=cfg.size, style_dim=cfg.latent_dim, channel_multiplier=cfg.channel_multiplier,
            channel_max=cfg.channel_max, constant_input=cfg.constant_input, dtype=dtype,
        )
        d = Discriminator(
            size=cfg.size, channel_multiplier=cfg.channel_multiplier, channel_max=cfg.channel_max, dtype=dtype
        )
    g, d = g.to(device).train(), d.to(device).train()
    g_ema = copy.deepcopy(g).requires_grad_(False).eval()
    return TrainState(
        step=0,
        g=g,
        d=d,
        g_ema=g_ema,
        g_optim=reg_adjusted_adam(g.parameters(), cfg.lr, cfg.g_reg_every),
        d_optim=reg_adjusted_adam(d.parameters(), cfg.lr, cfg.d_reg_every),
        lookahead=lookahead_minimax_init(g.parameters(), d.parameters()) if cfg.lookahead else None,
        mean_path_length=torch.zeros((), device=device),
        ada_p=cfg.augment_p,
    )


# ---------------------------------------------------------------- draws
@dataclass
class MixDraw:
    """The draws of one style-mixed synthesis of `batch` samples: z1, z2
    [B, latent_dim]; mix [B] bool (mix this sample); inject [B] int64 in
    [1, n_latent) (the first layer that takes w2); noise: one [B, 1, H, W]
    unit normal per layer."""

    z1: torch.Tensor
    z2: torch.Tensor
    mix: torch.Tensor
    inject: torch.Tensor
    noise: list[torch.Tensor]


@dataclass
class PathDraw(MixDraw):
    """A MixDraw plus the unit normal image noise [B, 3, H, W] of the
    path-length projection (divided by sqrt(H*W) in the loss)."""

    img_noise: torch.Tensor = None  # type: ignore[assignment]


@dataclass
class StepDraws:
    """Draws of one step: `d` and `g` hold one MixDraw per microbatch, `path`
    one PathDraw per path chunk (num_accumulate * reg_chunks) when the path
    penalty is due, else none."""

    d: list[MixDraw]
    g: list[MixDraw]
    path: list[PathDraw] = field(default_factory=list)


def _n_latent(size: int) -> int:
    return int(math.log2(size)) * 2 - 2


def _reg_k(cfg: TrainConfig) -> int:
    return max(1, cfg.reg_chunks)


def _path_batch(cfg: TrainConfig) -> int:
    return max(1, cfg.batch_size // max(cfg.path_batch_shrink, 1) // _reg_k(cfg))


def path_due(cfg: TrainConfig, step: int) -> bool:
    return cfg.path_regularize > 0 and step % cfg.g_reg_every == 0


def r1_due(cfg: TrainConfig, step: int) -> bool:
    return cfg.r1 > 0 and step % cfg.d_reg_every == 0


def draw_step(cfg: TrainConfig, step: int, generator: torch.Generator, device: DeviceLike = None) -> StepDraws:
    """All random draws of step `step`, from `generator` (a torch.Generator on
    `device`), in the order d, g, path."""
    device = resolve_device(device)
    n_latent = _n_latent(cfg.size)
    shapes = noise_shapes(cfg.size)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    def mix_draw(batch, cls=MixDraw, **extra):
        z1, z2 = normal(batch, cfg.latent_dim), normal(batch, cfg.latent_dim)
        mix = torch.rand((batch,), generator=generator, device=device) < cfg.mixing_prob
        inject = torch.randint(1, n_latent, (batch,), generator=generator, device=device)
        noise = [normal(batch, 1, s[2], s[3]) for s in shapes]
        return cls(z1, z2, mix, inject, noise, **extra)

    draws = StepDraws(
        d=[mix_draw(cfg.batch_size) for _ in range(cfg.num_accumulate)],
        g=[mix_draw(cfg.batch_size) for _ in range(cfg.num_accumulate)],
    )
    if path_due(cfg, step):
        pb = _path_batch(cfg)
        for _ in range(cfg.num_accumulate * _reg_k(cfg)):
            d = mix_draw(pb)
            draws.path.append(PathDraw(d.z1, d.z2, d.mix, d.inject, d.noise, normal(pb, 3, cfg.size, cfg.size)))
    return draws


def mixed_wplus(g: Generator, draw: MixDraw) -> torch.Tensor:
    """Per-sample style-mixed W+ [B, n_latent, D]: layers from the inject
    index on take w2, the others w1; an unmixed sample takes w1 throughout
    (maua_tpu/train/step.py:237-257)."""
    n_latent = g.n_latent
    w1, w2 = g.get_latent(draw.z1), g.get_latent(draw.z2)
    inject = torch.where(draw.mix, draw.inject, torch.full_like(draw.inject, n_latent))
    take_w2 = torch.arange(n_latent, device=w1.device)[None, :, None] >= inject[:, None, None]
    return torch.where(take_w2, w2[:, None, :], w1[:, None, :])


def synth(g: Generator, wplus: torch.Tensor, noise: list[torch.Tensor]) -> torch.Tensor:
    """G's image [B, 3, H, W] (fp32) from W+ with explicit per-layer noise."""
    return g(wplus, input_is_latent=True, noise=noise, randomize_noise=False)[0]


def _add_grads(params: list[torch.Tensor], loss: torch.Tensor, acc: Optional[list[torch.Tensor]]) -> list[torch.Tensor]:
    """acc + d loss / d params; a parameter the loss does not reach (R1 does
    not reach D's last bias) gets zeros, so that Adam steps it as optax does."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    return grads if acc is None else [a + g for a, g in zip(acc, grads)]


def _apply(optim: torch.optim.Optimizer, params: list[torch.Tensor], grads: list[torch.Tensor]) -> None:
    for p, gr in zip(params, grads):
        p.grad = gr
    optim.step()
    for p in params:
        p.grad = None


def make_train_phases(cfg: TrainConfig) -> dict[str, Callable[..., Any]]:
    """The train step's phases, each callable on its own (so that they can be
    timed one by one), updating the state in place:

      d(state, real [A, B, 3, H, W], draws.d)  -> (aux, grads)
      r1(state, real)                          -> (r1 sum, grads)
      g(state, draws.g)                        -> (loss sum, grads)
      path(state, draws.path)                  -> (penalty sum, grads)
      tail(state)                              -> None (lookahead, EMA, step + 1)
    """
    _check_supported(cfg)
    reg_k = _reg_k(cfg)
    n_acc = cfg.num_accumulate
    if cfg.batch_size % reg_k != 0:
        raise ValueError(f"reg_chunks ({reg_k}) must divide batch_size ({cfg.batch_size})")

    def check_chunks(d: Discriminator) -> None:
        if reg_k > 1 and (cfg.batch_size // reg_k) % d.stddev_group != 0:
            # a chunk of whole stddev groups keeps R1's D function that of the
            # unchunked batch; anything else regroups the statistic
            raise ValueError(
                f"batch_size/reg_chunks ({cfg.batch_size // reg_k}) must be a multiple of "
                f"the discriminator stddev group ({d.stddev_group})"
            )

    # ---------------- D phase ----------------
    def d_phase(state: TrainState, real_imgs: torch.Tensor, draws: list[MixDraw]):
        g, d = state.g, state.d
        params = list(d.parameters())
        grads = None
        aux = {"d_loss": 0.0, "real_score": 0.0, "fake_score": 0.0}
        with tf32(conv=False, matmul=False):
            for real, draw in zip(real_imgs, draws):
                b = real.shape[0]
                with torch.no_grad():
                    fake = synth(g, mixed_wplus(g, draw), draw.noise)
                if b % d.stddev_group == 0:
                    # one interleaved [f0, r0, f1, r1, ...] application: the
                    # stddev groups stride by 2B / group, an even number, so
                    # each group is all fake or all real
                    pred = d(torch.stack([fake, real], dim=1).reshape(2 * b, *real.shape[1:]))
                    fake_pred, real_pred = pred[0::2], pred[1::2]
                else:
                    fake_pred, real_pred = d(fake), d(real)
                loss = d_logistic_loss(real_pred, fake_pred)
                grads = _add_grads(params, loss / n_acc, grads)
                aux["d_loss"] += loss.detach()
                aux["real_score"] += real_pred.detach().mean()
                aux["fake_score"] += fake_pred.detach().mean()
        _apply(state.d_optim, params, grads)
        return aux, grads

    # ---------------- R1 phase (lazy) ----------------
    def r1_phase(state: TrainState, real_imgs: torch.Tensor):
        d = state.d
        check_chunks(d)
        params = list(d.parameters())
        a, b = real_imgs.shape[:2]
        # strided chunks: chunk c holds samples c, c + k, c + 2k, ... Minibatch
        # stddev groups along the outer axis (member g of statistic j is sample
        # g * B / group + j), so a strided chunk of whole groups holds exactly
        # the unchunked batch's groups, and chunked R1 is the unchunked R1.
        # (The JAX package cuts contiguous chunks, which regroups the statistic.)
        chunks = real_imgs.reshape(a, b // reg_k, reg_k, *real_imgs.shape[2:]).transpose(1, 2)
        chunks = chunks.reshape(a * reg_k, b // reg_k, *real_imgs.shape[2:])
        grads, r1_sum = None, 0.0
        with tf32(conv=False, matmul=False):
            for chunk in chunks:  # raw reals, as the reference
                r1 = d_r1_penalty(d, chunk)
                grads = _add_grads(params, cfg.r1 * cfg.d_reg_every * r1 / (n_acc * reg_k), grads)
                r1_sum += r1.detach() / reg_k
        _apply(state.d_optim, params, grads)
        return r1_sum, grads

    # ---------------- G phase ----------------
    def g_phase(state: TrainState, draws: list[MixDraw]):
        g, d = state.g, state.d
        params = list(g.parameters())
        grads, loss_sum = None, 0.0
        with tf32(conv=False, matmul=False):
            for draw in draws:
                wplus = mixed_wplus(g, draw)
                if cfg.remat_synth:
                    # the noise is an argument: the recompute sees the same draws
                    fake = checkpoint(lambda w, *n: synth(g, w, list(n)), wplus, *draw.noise, use_reentrant=False)
                else:
                    fake = synth(g, wplus, draw.noise)
                loss = g_nonsaturating_loss(d(fake))
                grads = _add_grads(params, loss / n_acc, grads)
                loss_sum += loss.detach()
        _apply(state.g_optim, params, grads)
        return loss_sum, grads

    # ---------------- path-length phase (lazy) ----------------
    def path_phase(state: TrainState, draws: list[PathDraw]):
        g = state.g
        params = list(g.parameters())
        grads, pen_sum = None, 0.0
        mpl = state.mean_path_length
        with tf32(conv=False, matmul=False):
            for draw in draws:
                # W+ from the mapping network, not detached: the penalty's
                # gradient reaches the mapping layers through it
                wplus = mixed_wplus(g, draw)
                penalty, mpl, _ = g_path_length_regularization(
                    lambda w: synth(g, w, draw.noise), wplus, mpl, draw.img_noise
                )
                loss = cfg.path_regularize * cfg.g_reg_every * penalty / (n_acc * reg_k)
                grads = _add_grads(params, loss, grads)
                pen_sum += penalty.detach() / reg_k
        _apply(state.g_optim, params, grads)
        state.mean_path_length = mpl
        return pen_sum, grads

    # ---------------- tail: lookahead-minimax + EMA ----------------
    def tail(state: TrainState) -> None:
        if cfg.lookahead and state.lookahead is not None:
            lookahead_minimax_step(state.lookahead, state.g.parameters(), state.d.parameters(), cfg.la_steps, cfg.la_alpha)
        ema_update(state.g_ema.parameters(), state.g.parameters(), cfg.ema_decay)
        state.step += 1

    return {"d": d_phase, "r1": r1_phase, "g": g_phase, "path": path_phase, "tail": tail}


def prepare_reals(real_imgs: torch.Tensor) -> torch.Tensor:
    """[A, B, H, W, 3] uint8 -> [A, B, 3, H, W] fp32 in [-1, 1] on the
    tensor's device (x / 127.5 - 1); a [A, B, 3, H, W] float batch passes."""
    chan_axis = 4 if real_imgs.dtype == torch.uint8 else 2
    if real_imgs.ndim != 5 or real_imgs.shape[chan_axis] != 3:
        want = "[A,B,H,W,3] uint8" if real_imgs.dtype == torch.uint8 else "[A,B,3,H,W] float"
        raise ValueError(f"train_step expects {want}, got {real_imgs.dtype} {tuple(real_imgs.shape)}")
    if real_imgs.dtype == torch.uint8:
        return real_imgs.permute(0, 1, 4, 2, 3).float() * (1.0 / 127.5) - 1.0
    return real_imgs.float()


def make_train_step(cfg: TrainConfig):
    """train_step(state, real_imgs, draws) -> metrics (0-d tensors, the JAX
    package's names). real_imgs: [A, B, 3, H, W] float in [-1, 1] or
    [A, B, H, W, 3] uint8 (normalised on its device); draws from `draw_step`
    for `state.step`."""
    phases = make_train_phases(cfg)

    def train_step(state: TrainState, real_imgs: torch.Tensor, draws: StepDraws) -> dict[str, torch.Tensor]:
        real_imgs = prepare_reals(real_imgs)
        zero = torch.zeros((), device=real_imgs.device)
        d_aux, _ = phases["d"](state, real_imgs, draws.d)
        r1_val = phases["r1"](state, real_imgs)[0] if r1_due(cfg, state.step) else zero
        g_loss, _ = phases["g"](state, draws.g)
        if path_due(cfg, state.step):
            if len(draws.path) != cfg.num_accumulate * _reg_k(cfg):
                raise ValueError(f"step {state.step}: the path penalty is due but the draws hold {len(draws.path)} path chunks")
            path_pen = phases["path"](state, draws.path)[0]
        else:
            path_pen = zero
        phases["tail"](state)
        n_acc = cfg.num_accumulate
        return {
            "Generator": g_loss / n_acc,
            "Discriminator": d_aux["d_loss"] / n_acc,
            "Real Score": d_aux["real_score"] / n_acc,
            "Fake Score": d_aux["fake_score"] / n_acc,
            "R1 Penalty": r1_val / n_acc,
            "Path Length Regularization": path_pen / n_acc,
            "Rt": zero,
            "Augment": torch.full((), float(state.ada_p), device=zero.device),
            "Mean Path Length": state.mean_path_length,
        }

    return train_step

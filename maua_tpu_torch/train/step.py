"""The StyleGAN2 train step: D phase (with ADA, bCR and the contrastive
regularizer), lazy R1, the adaptive-p update, G phase, lazy path-length
regularization, lookahead-minimax and EMA (counterpart of
maua_tpu/train/step.py).

The JAX step is one jitted pure function of (state, batch, rng). Here the
state holds the modules and optimizers and the phases update it in place:

* `init_train_state(cfg, seed, device)` builds G, D, the EMA copy of G, one
  Adam for each network with the lazy-regularization ratio (lr * r, betas
  0**r and 0.99**r, r = n / (n + 1)), the lookahead cache, the running
  path-length mean, ADA's p and sign counts (0-d device tensors, so neither
  the augmentation nor the update reads them on the host) and, with the
  contrastive regularizer, its projection head (trained by D's Adam, which
  R1 steps with zero gradients for it, as optax steps (d_params, cl_head))
  and its MoCo state. R1 steps D's optimizer and the path penalty G's, as
  in the JAX package.
* Every random draw of a step is made up front by `draw_step` from one
  `torch.Generator`: z1, z2, the mixing mask and inject index, the per-layer
  noise, the augmentation variates and the path-length image noise. The step
  consumes them, so a test can hand both packages the same draws, and a
  rematerialised synthesis (`torch.utils.checkpoint`, which restores only
  the global RNG) sees the same noise when it runs again.
* `make_train_phases(cfg)` returns the phases `d`, `r1`, `ada`, `g`, `path`
  and `tail`; `make_train_step(cfg)` composes them in the JAX order. Each of
  `d`, `r1`, `g` and `path` returns (aux, grads) after its optimizer step,
  grads in the order of the network's `parameters()` (D's followed by the
  head's).
* Each phase holds TF32 off (`tf32(False, False)`) over its forward and its
  backward: cuDNN's default would run the backward convs in TF32.

Data parallelism: when a torch.distributed process group is open (the train
CLI's `--coordinator`), `cfg.batch_size` is the global batch and each rank
holds a contiguous block of it (the loader's, and its block of every draw:
`draw_step` draws the global batch's variates from the same generator on
every rank, and the step keeps this rank's rows). Gradients are averaged over
the ranks before each optimizer step, which is the gradient of the loss over
the global batch. The minibatch stddev of D groups over the global batch (an
all-gather of the features that is differentiable to any order, R1's double
backward included), the path-length mean is the global mean, ADA's sign
counts are summed over the ranks, and the logged losses are averaged. EMA and
lookahead run on every rank on the same weights. R1's strided chunks of the
local block, laid end to end over the ranks, are the one-process chunks (the
local batch is a multiple of `reg_chunks`), so chunked R1 sees the
one-process stddev groups; each path chunk is drawn for the global chunk and
cut per rank. The contrastive regularizer gathers the projected queries and
keys of every rank (fakes, then reals) and computes its loss over the global
batch on every rank; every rank enqueues the same global keys and moves its
key encoder from the same D. `check_split` refuses, before the first step, a
batch that the ranks cannot split.

Exact options: gradient accumulation over `num_accumulate` microbatches,
`reg_chunks` for R1 (sequential strided chunks, guarded so that a chunk keeps
whole minibatch-stddev groups) and `remat_synth` (activation checkpointing of
G's synthesis in the G phase; the augmentation runs after it). The path
penalty in `reg_chunks` chunks draws fresh latents for each chunk, as the JAX
package does: the same estimator, not the same numbers. R1 stays on raw
reals, so no double backward passes through the warp. `s2d_min_res` and
`fast_phase_noise` are TPU layouts and are ignored.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..models import Discriminator, Generator, channel_map
from ..models.blocks import tf32
from ..models.stylegan2 import noise_shapes
from ..parallel import all_reduce_mean_, all_reduce_mean_tree, all_reduce_sum, gather_batch, process_count, tree_rows
from .augment import AugmentDraw, ada_adjust_p, augment, draw_augment
from .contrastive import (
    ContrastiveState,
    ProjectionHead,
    contrastive_regularizer_moco,
    init_contrastive_state,
    momentum_update,
)
from .ema import EMA_DECAY_DEFAULT, ema_update
from .lookahead import LookaheadState, lookahead_minimax_init, lookahead_minimax_step
from .losses import d_logistic_loss, d_r1_penalty, g_nonsaturating_loss, g_path_length_regularization

__all__ = [
    "MixDraw",
    "PathDraw",
    "StepDraws",
    "TrainConfig",
    "TrainState",
    "check_split",
    "draw_step",
    "init_train_state",
    "local_draws",
    "make_train_config",
    "make_train_phases",
    "make_train_step",
    "reg_adjusted_adam",
]


class TrainConfig(NamedTuple):
    """Training hyper-parameters: the fields and defaults of the JAX package's
    TrainConfig (maua_tpu/train/step.py:40-114)."""

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
    augment: bool = True  # ADA
    augment_p: float = 0.0  # 0 = adaptive
    ada_target: float = 0.6
    ada_length: float = 15_000.0  # per real prediction
    lookahead: bool = True
    la_steps: int = 500
    la_alpha: float = 0.5
    ema_decay: float = EMA_DECAY_DEFAULT
    bcr_weight: float = 0.0  # balanced consistency regularization
    contrastive_weight: float = 0.0  # SimCLR regularizer on D's hidden layer
    contrastive_loss_type: str = "infonce"  # "infonce" | "nt_xent"
    # MoCo options: the key encoder's momentum (0 = keys through D itself) and
    # a queue of past keys as extra negatives (0 = none; a multiple of
    # 2 * batch_size: the fakes' and reals' keys are enqueued together)
    contrastive_momentum: float = 0.0
    contrastive_queue: int = 0
    contrastive_bilinear: bool = False  # bilinear key transform
    bf16: bool = False  # bf16 convs in G synthesis and D (parameters stay fp32)
    s2d_min_res: int = -1  # TPU layout: ignored
    ada_fast_warp: bool = False  # 1x-output-grid matmul warp
    ada_warp_method: Optional[str] = None  # "fft" | "matmul" | "conv"; None = by ada_fast_warp and device
    ada_fft_taper: Optional[float] = 0.85  # fft warp's band taper (None = off)
    ada_fft_taper_conditional: bool = True  # taper only fractionally shifted rows
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


STDDEV_GROUP = 4  # the Discriminator's minibatch-stddev group


def fused_d_pass(cfg: TrainConfig, stddev_group: int = STDDEV_GROUP) -> bool:
    """Whether the D phase applies D once to the interleaved [f0, r0, f1, r1,
    ...] batch (and augments it with one [2B] draw): the stddev groups then
    stride by 2B / group, an even number, so each group is all fake or all
    real. bCR and the contrastive regularizer need the halves apart."""
    return cfg.batch_size % stddev_group == 0 and cfg.bcr_weight == 0 and cfg.contrastive_weight == 0


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
    ada_p: torch.Tensor  # 0-d fp32 on the device, and the two sign counts
    ada_signs: torch.Tensor
    ada_n: torch.Tensor
    cl_head: Optional[ProjectionHead] = None
    cl_state: Optional[ContrastiveState] = None

    @property
    def device(self) -> torch.device:
        return self.mean_path_length.device

    def d_params(self) -> list[torch.Tensor]:
        """What D's optimizer steps: D's parameters, then the head's."""
        head = [] if self.cl_head is None else list(self.cl_head.parameters())
        return list(self.d.parameters()) + head


def init_train_state(cfg: TrainConfig, seed: int = 0, device: DeviceLike = None) -> TrainState:
    """Models, optimizers and the rest of the state, on `device` (default
    `cuda`; raises RuntimeError without a card). Weights are drawn from the
    CPU generator seeded with `seed`, without touching the global RNG; the
    projection head's from a CPU generator seeded with `seed + 7`."""
    device = resolve_device(device)
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
    d.cross_rank_stddev = dist.is_initialized()  # the stddev statistic over the global batch
    g_ema = copy.deepcopy(g).requires_grad_(False).eval()
    cl_head = cl_state = None
    if cfg.contrastive_weight > 0:
        if cfg.contrastive_queue > 0 and cfg.contrastive_queue % (2 * cfg.batch_size) != 0:
            raise ValueError(
                f"contrastive_queue ({cfg.contrastive_queue}) must be a multiple of 2*batch_size "
                f"({2 * cfg.batch_size}): the fakes' and reals' keys are enqueued together"
            )
        feat_dim = channel_map(cfg.channel_multiplier, cfg.channel_max)[4] * 4 * 4  # D's hidden layer, [C, 4, 4]
        cl_head = ProjectionHead(feat_dim, bilinear=cfg.contrastive_bilinear,
                                 generator=torch.Generator().manual_seed(seed + 7)).to(device)
        cl_state = init_contrastive_state(d, cfg.contrastive_momentum > 0, cfg.contrastive_queue, device=device)
    zero = torch.zeros((), device=device)
    head_params = [] if cl_head is None else list(cl_head.parameters())
    return TrainState(
        step=0,
        g=g,
        d=d,
        g_ema=g_ema,
        g_optim=reg_adjusted_adam(g.parameters(), cfg.lr, cfg.g_reg_every),
        d_optim=reg_adjusted_adam(list(d.parameters()) + head_params, cfg.lr, cfg.d_reg_every),
        lookahead=lookahead_minimax_init(g.parameters(), d.parameters()) if cfg.lookahead else None,
        mean_path_length=zero,
        ada_p=torch.full((), cfg.augment_p, device=device),
        ada_signs=zero.clone(),
        ada_n=zero.clone(),
        cl_head=cl_head,
        cl_state=cl_state,
    )


# ---------------------------------------------------------------- draws
@dataclass
class MixDraw:
    """The draws of one style-mixed synthesis of `batch` samples: z1, z2
    [B, latent_dim]; mix [B] bool (mix this sample); inject [B] int64 in
    [1, n_latent) (the first layer that takes w2); noise: one [B, 1, H, W]
    unit normal per layer; aug: the augmentation draws of the images made
    from it (none without ADA; in the D phase one of [2B] for the fused
    fake/real pass, else one for the fakes and one for the reals; in the G
    phase one of [B])."""

    z1: torch.Tensor
    z2: torch.Tensor
    mix: torch.Tensor
    inject: torch.Tensor
    noise: list[torch.Tensor]
    aug: tuple[AugmentDraw, ...] = ()


@dataclass
class PathDraw(MixDraw):
    """A MixDraw plus the unit normal image noise [B, 3, H, W] of the
    path-length projection (divided by sqrt(H*W) in the loss)."""

    img_noise: torch.Tensor = None  # type: ignore[assignment]


@dataclass
class StepDraws:
    """Draws of one step: `d` and `g` hold one MixDraw per microbatch (with
    its augmentation draws), `path` one PathDraw per path chunk
    (num_accumulate * reg_chunks) when the path penalty is due, else none."""

    d: list[MixDraw]
    g: list[MixDraw]
    path: list[PathDraw] = field(default_factory=list)


def _n_latent(size: int) -> int:
    return int(math.log2(size)) * 2 - 2


def _reg_k(cfg: TrainConfig) -> int:
    return max(1, cfg.reg_chunks)


def _path_batch(cfg: TrainConfig) -> int:
    return max(1, cfg.batch_size // max(cfg.path_batch_shrink, 1) // _reg_k(cfg))


def _split_problems(cfg: TrainConfig, world: int) -> list[str]:
    b, k = cfg.batch_size, _reg_k(cfg)
    problems = []
    if b % world:
        problems.append(f"the global batch {b} does not split over {world} ranks")
    elif (b // world) % k:
        problems.append(f"the local batch {b // world} (global batch {b} over {world} ranks) does not split "
                        f"into reg_chunks {k} R1 chunks")
    if cfg.path_regularize > 0 and _path_batch(cfg) % world:
        problems.append(f"the path penalty's chunk of {_path_batch(cfg)} rows (global batch {b} // path_batch_shrink "
                        f"{cfg.path_batch_shrink} // reg_chunks {k}) does not split over {world} ranks")
    return problems


def _splitting_chunks(cfg: TrainConfig, world: int, stddev_group: int) -> list[int]:
    """The reg_chunks that split a step of `cfg` over `world` ranks and keep
    whole stddev groups in a chunk."""
    b = cfg.batch_size
    return [k for k in range(1, b + 1) if b % k == 0 and (k == 1 or (b // k) % stddev_group == 0)
            and not _split_problems(cfg._replace(reg_chunks=k), world)]


def check_split(cfg: TrainConfig, world: int, stddev_group: int = STDDEV_GROUP) -> None:
    """Raise ValueError where the `world` data-parallel ranks cannot split a
    step of `cfg`: the global batch, R1's chunks of the local batch, or the
    path penalty's chunk (GSPMD would pad it; the port does not). The message
    names the numbers and the reg_chunks (`--reg_chunks`) that would split,
    or, where none does, the next global batch that splits."""
    problems = _split_problems(cfg, world)
    if not problems:
        return
    batch = cfg.batch_size
    fits = _splitting_chunks(cfg, world, stddev_group)
    while not fits:  # ends: a multiple of path_batch_shrink * world splits unchunked
        batch += 1
        fits = _splitting_chunks(cfg._replace(batch_size=batch), world, stddev_group)
    ks = " or ".join(map(str, fits))
    if batch == cfg.batch_size:
        hint = f"reg_chunks (--reg_chunks) {ks} would split it"
    else:
        hint = (f"no reg_chunks splits a global batch of {cfg.batch_size} over {world} ranks; "
                f"a global batch of {batch} splits with reg_chunks (--reg_chunks) {ks}")
    raise ValueError(f"{'; '.join(problems)}: {hint}")


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
    b = cfg.batch_size

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    def mix_draw(batch, aug_batches=()):
        z1, z2 = normal(batch, cfg.latent_dim), normal(batch, cfg.latent_dim)
        mix = torch.rand((batch,), generator=generator, device=device) < cfg.mixing_prob
        inject = torch.randint(1, n_latent, (batch,), generator=generator, device=device)
        noise = [normal(batch, 1, s[2], s[3]) for s in shapes]
        aug = tuple(draw_augment(n, generator, device) for n in aug_batches) if cfg.augment else ()
        return MixDraw(z1, z2, mix, inject, noise, aug)

    d_aug = (2 * b,) if fused_d_pass(cfg) else (b, b)
    draws = StepDraws(
        d=[mix_draw(b, d_aug) for _ in range(cfg.num_accumulate)],
        g=[mix_draw(b, (b,)) for _ in range(cfg.num_accumulate)],
    )
    if path_due(cfg, step):
        pb = _path_batch(cfg)
        for _ in range(cfg.num_accumulate * _reg_k(cfg)):
            d = mix_draw(pb)
            draws.path.append(PathDraw(d.z1, d.z2, d.mix, d.inject, d.noise,
                                       img_noise=normal(pb, 3, cfg.size, cfg.size)))
    return draws


def local_draws(draws: StepDraws) -> StepDraws:
    """This rank's rows of every draw of a step: a contiguous block of the
    batch axis, the last axis of an augmentation variate ([B] or [n, B])."""

    def mix(d: MixDraw) -> MixDraw:
        fields = {k: tree_rows(getattr(d, k)) for k in ("z1", "z2", "mix", "inject", "noise")}
        fields["aug"] = tuple(tree_rows(a, axis=-1) for a in d.aug)
        if isinstance(d, PathDraw):
            return PathDraw(**fields, img_noise=tree_rows(d.img_noise))
        return MixDraw(**fields)

    return StepDraws(d=[mix(x) for x in draws.d], g=[mix(x) for x in draws.g], path=[mix(x) for x in draws.path])


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
    """Average the gradients over the ranks (in place; a no-op in one
    process) and step the optimizer with them."""
    all_reduce_mean_(grads)
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
      ada(state, d aux)                        -> r_t
      g(state, draws.g)                        -> (loss sum, grads)
      path(state, draws.path)                  -> (penalty sum, grads)
      tail(state)                              -> None (lookahead, EMA, step + 1)
    """
    reg_k = _reg_k(cfg)
    n_acc = cfg.num_accumulate
    if cfg.batch_size % reg_k != 0:
        raise ValueError(f"reg_chunks ({reg_k}) must divide batch_size ({cfg.batch_size})")
    check_split(cfg, process_count())
    aug_kw = dict(fast_warp=cfg.ada_fast_warp, warp_method=cfg.ada_warp_method, fft_taper=cfg.ada_fft_taper,
                  fft_taper_conditional=cfg.ada_fft_taper_conditional)
    adt = torch.bfloat16 if cfg.bf16 else torch.float32  # augment in D's compute dtype

    def check_chunks(d: Discriminator) -> None:
        if reg_k > 1 and (cfg.batch_size // reg_k) % d.stddev_group != 0:
            # a chunk of whole stddev groups keeps R1's D function that of the
            # unchunked batch; anything else regroups the statistic
            raise ValueError(
                f"batch_size/reg_chunks ({cfg.batch_size // reg_k}) must be a multiple of "
                f"the discriminator stddev group ({d.stddev_group})"
            )

    def aug_draws(draw: MixDraw, n: int) -> tuple[AugmentDraw, ...]:
        if len(draw.aug) != n:
            raise ValueError(f"augmentation is on and this pass takes {n} augmentation draws; the draw holds {len(draw.aug)}")
        return draw.aug

    def aug(img: torch.Tensor, p: torch.Tensor, draw: AugmentDraw) -> torch.Tensor:
        return augment(img, p, draw, **aug_kw)[0]

    # ---------------- D phase ----------------
    def d_microbatch(state: TrainState, real: torch.Tensor, draw: MixDraw, cl_state):
        g, d = state.g, state.d
        b = real.shape[0]
        with torch.no_grad():
            fake = synth(g, mixed_wplus(g, draw), draw.noise)
        fake_in, real_in = fake.to(adt), real.to(adt)
        fuse = fused_d_pass(cfg, d.stddev_group)
        if fuse:
            # one interleaved [f0, r0, f1, r1, ...] pass, augmented with one draw
            both = torch.stack([fake_in, real_in], dim=1).reshape(2 * b, *real.shape[1:])
            if cfg.augment:
                both = aug(both, state.ada_p, aug_draws(draw, 1)[0])
            pred = d(both)
            fake_pred, real_pred = pred[0::2], pred[1::2]
        else:
            if cfg.augment:
                fake_draw, real_draw = aug_draws(draw, 2)
                fake_aug, real_aug = aug(fake_in, state.ada_p, fake_draw), aug(real_in, state.ada_p, real_draw)
            else:
                fake_aug, real_aug = fake, real
            fake_pred, real_pred = d(fake_aug), d(real_aug)
        loss = d_logistic_loss(real_pred, fake_pred)
        if cfg.bcr_weight > 0:  # balanced consistency: augmented against raw
            bcr = (real_pred - d(real)).square().mean() + (fake_pred - d(fake)).square().mean()
            loss = loss + cfg.bcr_weight * bcr
        if cfg.contrastive_weight > 0:
            # queries from the raw fakes and reals, keys from their augmented copies
            key_d = None if cl_state is None else cl_state.key_d
            cl, cl_state = contrastive_regularizer_moco(
                d.hidden, None if key_d is None else key_d.hidden, state.cl_head, cl_state,
                [fake, real], [fake_aug, real_aug], loss_type=cfg.contrastive_loss_type, gather=gather_batch,
            )
            loss = loss + cfg.contrastive_weight * cl
        aux = {"d_loss": loss.detach(), "real_score": real_pred.detach().mean(), "fake_score": fake_pred.detach().mean(),
               "sign_sum": torch.sign(real_pred.detach()).sum(),
               "n_pred": torch.full((), float(real_pred.shape[0]), device=real.device)}
        return loss, aux, cl_state

    def d_phase(state: TrainState, real_imgs: torch.Tensor, draws: list[MixDraw]):
        params = state.d_params()
        grads, aux, cl_state = None, None, state.cl_state
        with tf32(conv=False, matmul=False):
            for real, draw in zip(real_imgs, draws):
                loss, mb_aux, cl_state = d_microbatch(state, real, draw, cl_state)
                grads = _add_grads(params, loss / n_acc, grads)
                aux = mb_aux if aux is None else {k: aux[k] + v for k, v in mb_aux.items()}
        aux["sign_sum"], aux["n_pred"] = all_reduce_sum(aux["sign_sum"]), all_reduce_sum(aux["n_pred"])
        _apply(state.d_optim, params, grads)
        if cfg.contrastive_momentum > 0:
            momentum_update(cl_state, state.d, cfg.contrastive_momentum)
        state.cl_state = cl_state
        return aux, grads

    # ---------------- R1 phase (lazy) ----------------
    def r1_phase(state: TrainState, real_imgs: torch.Tensor):
        d = state.d
        check_chunks(d)
        params = state.d_params()  # the head takes zero gradients
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

    # ---------------- ADA p-adaptation, between R1 and G ----------------
    def ada_phase(state: TrainState, d_aux: dict) -> torch.Tensor:
        if not (cfg.augment and cfg.augment_p == 0):
            return torch.zeros((), device=state.device)
        state.ada_p, state.ada_signs, state.ada_n, r_t = ada_adjust_p(
            state.ada_p, state.ada_signs + d_aux["sign_sum"], state.ada_n + d_aux["n_pred"],
            cfg.ada_target, cfg.ada_length,
        )
        return r_t

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
                if cfg.augment:
                    fake = aug(fake.to(adt), state.ada_p, aug_draws(draw, 1)[0])
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
                    lambda w: synth(g, w, draw.noise), wplus, mpl, draw.img_noise, gather=gather_batch
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

    return {"d": d_phase, "r1": r1_phase, "ada": ada_phase, "g": g_phase, "path": path_phase, "tail": tail}


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
    package's names, plus the D phase's `sign_sum` and `n_pred` of real
    predictions that feed ADA's p). real_imgs: [A, B, 3, H, W] float in
    [-1, 1] or [A, B, H, W, 3] uint8 (normalised on its device); draws from
    `draw_step` for `state.step`."""
    phases = make_train_phases(cfg)

    def train_step(state: TrainState, real_imgs: torch.Tensor, draws: StepDraws) -> dict[str, torch.Tensor]:
        real_imgs = prepare_reals(real_imgs)
        if dist.is_initialized():
            draws = local_draws(draws)
        zero = torch.zeros((), device=real_imgs.device)
        d_aux, _ = phases["d"](state, real_imgs, draws.d)
        r1_val = phases["r1"](state, real_imgs)[0] if r1_due(cfg, state.step) else zero
        r_t = phases["ada"](state, d_aux)
        g_loss, _ = phases["g"](state, draws.g)
        if path_due(cfg, state.step):
            if len(draws.path) != cfg.num_accumulate * _reg_k(cfg):
                raise ValueError(f"step {state.step}: the path penalty is due but the draws hold {len(draws.path)} path chunks")
            path_pen = phases["path"](state, draws.path)[0]
        else:
            path_pen = zero
        phases["tail"](state)
        n_acc = cfg.num_accumulate
        losses = all_reduce_mean_tree({
            "Generator": g_loss / n_acc,
            "Discriminator": d_aux["d_loss"] / n_acc,
            "Real Score": d_aux["real_score"] / n_acc,
            "Fake Score": d_aux["fake_score"] / n_acc,
            "R1 Penalty": r1_val / n_acc,
            "Path Length Regularization": path_pen / n_acc,
        })
        return {
            **losses,
            "Rt": r_t,
            "Augment": state.ada_p,
            "Mean Path Length": state.mean_path_length,
            "sign_sum": d_aux["sign_sum"],
            "n_pred": d_aux["n_pred"],
        }

    return train_step

"""Training entry point: the host loop around the train step (counterpart of
maua_tpu/train/cli.py; the same flags, plus `--device`).

    python -m maua_tpu_torch.train.cli --path shards/ --size 256 --batch_size 12 --no-augment

`--augment` keeps the JAX package's default (on), and ADA is not ported yet,
so the plain command raises until it is: pass `--no-augment`. Flags for work
that waits for a later part of the port raise NotImplementedError when set:
bCR and contrastive (with ADA), eval / FID / SWD, wandb, spectral norms, the
device monitor and the trace capture (telemetry), and multi-host runs. The
TPU layouts (`--s2d_min_res`) and the settings of ADA and the contrastive
regularizer are accepted and ignored.

Each logged step appends one JSON line to `<run_dir>/metrics.jsonl` with the
JAX package's metric names, `step`, `sec_per_iter` (wall time per step since
the last log, the step's work synchronised by reading the metrics) and the
launches of the two fused bias + leaky-ReLU kernels in the logged steps'
train steps (`fused_bias_act launches`, `fused_bias_act_grad launches`;
0 on the CPU, where the plain forms run).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..data import DataLoader, MultiResolutionRecordDataset
from ..device import resolve_device
from ..ops import fused_act
from .checkpoint import (
    is_port_checkpoint,
    latest_checkpoint,
    load_torch_training_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from .step import TrainState, draw_step, init_train_state, make_train_config, make_train_step

__all__ = ["build_parser", "main", "save_image_grid", "train_loop"]


def save_image_grid(images: np.ndarray, path: str, n_cols: int = 4) -> None:
    """[-1, 1] NCHW -> contact sheet png."""
    from PIL import Image

    imgs = ((np.clip(images, -1, 1) + 1) * 127.5).astype(np.uint8).transpose(0, 2, 3, 1)
    n, h, w, _ = imgs.shape
    sheet = np.zeros((-(-n // n_cols) * h, n_cols * w, 3), np.uint8)
    for i, img in enumerate(imgs):
        r, c = divmod(i, n_cols)
        sheet[r * h : (r + 1) * h, c * w : (c + 1) * w] = img
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(sheet).save(path)


def _refuse_unported(args) -> None:
    if args.augment:
        raise NotImplementedError(
            "ADA augmentation (--augment, on by default as in maua_tpu) is not ported to "
            "maua_tpu_torch yet (ROADMAP item 11, Queue 2c): pass --no-augment"
        )
    unported = {
        "--balanced_consistency": (args.balanced_consistency > 0, "ROADMAP item 11, with ADA"),
        "--contrastive": (args.contrastive > 0, "ROADMAP item 11, with ADA"),
        "--eval_every": (args.eval_every > 0, "evaluation, ROADMAP item 12"),
        "--wandb": (args.wandb, "logging goes to metrics.jsonl"),
        "--log_spec_norm": (args.log_spec_norm, "telemetry, ROADMAP item 14"),
        "--monitor": (args.monitor, "telemetry, ROADMAP item 14"),
        "--profile": (args.profile, "telemetry, ROADMAP item 14"),
        "--coordinator/--num_processes/--process_id": (
            any(v is not None for v in (args.coordinator, args.num_processes, args.process_id)),
            "multi-host training, ROADMAP item 13",
        ),
    }
    for flag, (is_set, where) in unported.items():
        if is_set:
            raise NotImplementedError(f"{flag} is not ported to maua_tpu_torch yet ({where})")


def train_loop(args) -> Optional[TrainState]:
    """Train from parsed arguments; returns the final state (None with
    --print_config)."""
    _refuse_unported(args)
    cfg = make_train_config(
        size=args.size,
        batch_size=args.batch_size,
        num_accumulate=args.num_accumulate,
        lr=args.lr,
        r1=args.r1,
        path_regularize=args.path_regularize,
        d_reg_every=args.d_reg_every,
        g_reg_every=args.g_reg_every,
        mixing_prob=args.mixing,
        channel_multiplier=args.channel_multiplier,
        channel_max=args.channel_max,
        constant_input=not args.noconst,
        augment=args.augment,
        augment_p=args.augment_p,
        lookahead=args.lookahead,
        la_steps=args.la_steps,
        la_alpha=args.la_alpha,
        bcr_weight=args.balanced_consistency,
        contrastive_weight=args.contrastive,
        bf16=args.bf16,
        s2d_min_res=args.s2d_min_res,
        # the same automatic rules as the JAX CLI: chunk the lazy regularizers
        # into stddev-group-sized pieces and rematerialise the G synthesis from
        # 512^2 on, where their peak memory bounds the batch
        reg_chunks=args.reg_chunks if args.reg_chunks > 0 else (max(1, args.batch_size // 4) if args.size >= 512 else 1),
        remat_synth=args.remat_synth > 0 if args.remat_synth >= 0 else args.size >= 512,
    )
    if args.print_config:
        print(json.dumps(cfg._asdict()))
        return None
    device = resolve_device(args.device)
    state = init_train_state(cfg, args.seed, device)
    step_fn = make_train_step(cfg)

    if args.checkpoint:
        ckpt = torch.load(args.checkpoint, map_location="cpu", weights_only=False)
        if is_port_checkpoint(ckpt):
            state = restore_checkpoint(args.checkpoint, state)
        else:
            state = load_torch_training_checkpoint(args.checkpoint, state, args.transfer_mapping_only)
    elif args.resume:
        latest = latest_checkpoint(args.run_dir)
        if latest:
            state = restore_checkpoint(latest, state)

    dataset = MultiResolutionRecordDataset(args.path, resolution=args.size, uint8_hwc=not args.no_uint8_loader)
    loader = DataLoader(
        dataset, batch_size=cfg.batch_size, num_accumulate=cfg.num_accumulate,
        num_workers=args.num_workers, seed=args.seed, device=device,
    )
    os.makedirs(args.run_dir, exist_ok=True)
    sample_z = torch.from_numpy(
        np.random.default_rng(args.seed + 1).standard_normal((args.n_sample, cfg.latent_dim), dtype=np.float32)
    ).to(device)
    draw_gen = torch.Generator(device=device).manual_seed(args.seed + 2)

    counts = {"fused_bias_act launches": 0, "fused_bias_act_grad launches": 0}
    try:
        with open(os.path.join(args.run_dir, "metrics.jsonl"), "a") as metrics_file:
            t_last = time.time()
            for i in range(state.step, args.iter):
                real = next(loader)
                draws = draw_step(cfg, state.step, draw_gen, device)
                before = (fused_act.launches, fused_act.grad_launches)
                metrics = step_fn(state, real, draws)
                counts["fused_bias_act launches"] += fused_act.launches - before[0]
                counts["fused_bias_act_grad launches"] += fused_act.grad_launches - before[1]

                if i % args.log_every == 0:
                    log = {k: float(v) for k, v in metrics.items()}  # synchronises the step
                    log["step"] = i
                    log["sec_per_iter"] = (time.time() - t_last) / max(args.log_every, 1)
                    log.update(counts)
                    counts = dict.fromkeys(counts, 0)
                    print(json.dumps({k: round(v, 5) if isinstance(v, float) else v for k, v in log.items()}), flush=True)
                    metrics_file.write(json.dumps(log) + "\n")
                    metrics_file.flush()
                    t_last = time.time()

                if args.img_every > 0 and i % args.img_every == 0:
                    with torch.no_grad():
                        imgs, _ = state.g_ema(sample_z, randomize_noise=False)
                    save_image_grid(imgs.cpu().numpy(), os.path.join(args.run_dir, f"samples/{i:07d}.png"))

                if args.checkpoint_every > 0 and i > 0 and i % args.checkpoint_every == 0:
                    save_checkpoint(args.run_dir, state, step=i)
        save_checkpoint(args.run_dir, state)
    finally:
        loader.close()
    return state


def build_parser() -> argparse.ArgumentParser:
    # the flags of maua_tpu/train/cli.py:379-477, plus --device
    p = argparse.ArgumentParser(description="maua_tpu_torch StyleGAN2 training")
    p.add_argument("--path", type=str, required=True, help="record-shard directory")
    p.add_argument("--device", type=str, default=None, help="torch device (default cuda; 'cpu' runs the plain forms)")
    p.add_argument("--run_dir", type=str, default="runs/default")
    p.add_argument("--iter", type=int, default=20_000)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=12)
    p.add_argument("--num_accumulate", type=int, default=1)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--r1", type=float, default=1e-5)
    p.add_argument("--path_regularize", type=float, default=2.0)
    p.add_argument("--d_reg_every", type=int, default=16)
    p.add_argument("--g_reg_every", type=int, default=4)
    p.add_argument("--mixing", type=float, default=0.9)
    p.add_argument("--channel_multiplier", type=int, default=2)
    p.add_argument("--channel_max", type=int, default=512,
                   help="fmap cap (StyleGAN fmap_max); narrow models for tests/smoke runs")
    p.add_argument("--noconst", action="store_true")
    p.add_argument("--augment", action="store_true", default=True, help="ADA: not ported yet, pass --no-augment")
    p.add_argument("--no-augment", dest="augment", action="store_false")
    p.add_argument("--augment_p", type=float, default=0.0)
    p.add_argument("--ada_target", type=float, default=0.6, help="ADA option: accepted and ignored")
    p.add_argument("--ada_length", type=float, default=15_000, help="ADA option: accepted and ignored")
    p.add_argument("--lookahead", action="store_true", default=True)
    p.add_argument("--no-lookahead", dest="lookahead", action="store_false")
    p.add_argument("--la_steps", type=int, default=500)
    p.add_argument("--la_alpha", type=float, default=0.5)
    p.add_argument("--balanced_consistency", type=float, default=0.0)
    p.add_argument("--print_config", action="store_true",
                   help="print the resolved TrainConfig as JSON and exit (wiring check)")
    p.add_argument("--bf16", action="store_true", help="bf16 convs in G and D (parameters fp32)")
    p.add_argument("--s2d_min_res", type=int, default=-1, help="TPU layout option: accepted and ignored")
    p.add_argument("--reg_chunks", type=int, default=-1,
                   help="split lazy-reg (R1/path) microbatches into k sequential chunks (exact); "
                        "-1 = auto (batch/4 at >=512^2, else 1)")
    p.add_argument("--remat_synth", type=int, default=-1,
                   help="activation checkpointing of G synthesis in the G phase (exact); -1 = auto (on at >=512^2)")
    p.add_argument("--ada_warp", type=str, default="auto", choices=["auto", "", "fft", "matmul", "conv"],
                   help="ADA option: accepted and ignored until ADA is ported")
    p.add_argument("--ada_fft_taper", type=float, default=0.85, help="ADA option: accepted and ignored")
    p.add_argument("--ada_fft_taper_always", action="store_true", help="ADA option: accepted and ignored")
    p.add_argument("--ada_fast_warp", type=int, default=-1, help="ADA option: accepted and ignored")
    p.add_argument("--contrastive", type=float, default=0.0)
    p.add_argument("--contrastive_momentum", type=float, default=0.0, help="contrastive option: accepted and ignored")
    p.add_argument("--contrastive_queue", type=int, default=0, help="contrastive option: accepted and ignored")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="a checkpoint of this trainer, or a rosinality {g, d, g_ema} .pt")
    p.add_argument("--transfer_mapping_only", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--checkpoint_every", type=int, default=1000)
    p.add_argument("--img_every", type=int, default=500)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--n_sample", type=int, default=8)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--no_uint8_loader", action="store_true",
                   help="ship fp32 CHW batches (host-side conversion) instead of uint8 NHWC")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--wandb_project", type=str, default="maua_tpu")
    p.add_argument("--log_spec_norm", action="store_true")
    p.add_argument("--eval_every", type=int, default=0, help="metric interval (0 = off; not ported yet)")
    p.add_argument("--eval_metric", type=str, default="fid", choices=["fid", "swd"])
    p.add_argument("--swd_n_sample", type=int, default=256)
    p.add_argument("--inception_stats", type=str, default=None)
    p.add_argument("--inception_weights", type=str, default=None)
    p.add_argument("--fid_inception", action="store_true")
    p.add_argument("--fid_n_sample", type=int, default=2500)
    p.add_argument("--fid_batch", type=int, default=6)
    p.add_argument("--profile", action="store_true")
    p.add_argument("--profile_iters", type=int, default=5)
    p.add_argument("--monitor", action="store_true")
    p.add_argument("--coordinator", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p


def main(argv=None) -> int:
    train_loop(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

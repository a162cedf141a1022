"""Training entry point: the host loop around the train step (counterpart of
maua_tpu/train/cli.py; the same flags, plus `--device`).

    python -m maua_tpu_torch.train.cli --path shards/ --size 256 --batch_size 12

ADA is on by default (`--augment`), with the JAX CLI's resolution rules:
`--ada_warp auto` is the FFT-shear warp on a CUDA device and the conv warp on
the CPU, `--ada_fast_warp -1` turns the 1x-grid warp on from 512^2,
`--ada_fft_taper 0` turns the fft warp's taper off. `--balanced_consistency`
and `--contrastive` (with `--contrastive_momentum` and `--contrastive_queue`)
run too. `--eval_every N` evaluates the EMA generator every N steps:
`--eval_metric swd` against the first `--swd_n_sample` reals, or `fid`
against `--inception_stats` (with `--inception_weights` / `--fid_inception`)
under the reference's truncation protocol; each score goes to stdout
(`{"SWD": ...}` / `{"FID": ...}`) and to metrics.jsonl (the metric's dict
with the same key, the eval's seconds and its forward-kernel launches
added). The TPU layout `--s2d_min_res` is accepted and ignored.

Telemetry: `--log_spec_norm` adds the power-iteration spectral norms of G's
and D's weights to each log line (`G spectral_min` / `_mean` / `_max`, the
same for D); `--monitor` starts the device monitor thread
(`<run_dir>/gpumon.jsonl`: bytes allocated per card now and at the peak,
host RSS, 30-sample means every 2 s); `--profile` traces the first
`--profile_iters` steps with torch.profiler into `<run_dir>/trace/`:
`trace.json`, `key_averages.txt` and `spans.json`, the program's spans over
those steps (the loader's `data`, `data.wait` and `data.assemble`, and
`train_step` with its phases `train_step.d`, `.r1`, `.ada`, `.g`, `.path` and
`.tail`, each timed on the device too) and their counters (`data.starved`,
`cuda.syncs`); the spans are also named ranges in the trace
(telemetry/profiling.py).
`--wandb` logs to wandb when it imports and initialises, and otherwise
prints `wandb unavailable (...)` and trains on.

Data parallelism: `--coordinator host:port --num_processes N --process_id i`
(or COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID) starts one of N
processes, one per card (`cuda:{i % cards}`; gloo with `--device cpu`).
`--batch_size` is the global batch; see train/step.py for what is reduced
over the ranks. `--reg_chunks` and `--remat_synth` resolve as without a
coordinator (from 512^2: batch_size // 4 chunks, remat on); a batch whose
local block, R1 chunks or path-penalty chunk the ranks cannot split raises
ValueError before the first step, naming a `--reg_chunks` that splits.
Rank 0 alone writes metrics, samples, checkpoints and wandb logs and runs
the monitor and the trace; evaluation in training is single-process and is
skipped.

Each logged step appends one JSON line to `<run_dir>/metrics.jsonl` with the
JAX package's metric names, the D phase's `sign_sum` and `n_pred` (ADA's
real-prediction counts), `step`, `sec_per_iter` (wall time per step since
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
from ..draws import Draws
from ..ops import fused_act
from ..parallel import (
    is_main_process,
    maybe_initialize_distributed,
    process_count,
    process_device,
    process_index,
    shutdown_distributed,
)
from ..telemetry import init_spectral_state, profile_trace, spectral_norms
from ..telemetry.monitor import DeviceMonitor
from ..telemetry.spectral import summarize
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


def init_wandb(args):
    """A wandb run when wandb imports and initialises, else None (after
    saying why)."""
    try:
        import wandb

        return wandb.init(project=args.wandb_project, config=vars(args))
    except Exception as e:  # no wandb, no login, no network: metrics.jsonl still gets every line
        print(f"wandb unavailable ({e}); logging to jsonl only", flush=True)
        return None


def _eval_mean_latent(g_ema, seed: int, device) -> torch.Tensor:
    """The EMA generator's mean of 2^14 mapped z from Draws(seed)."""
    return g_ema.get_latent(Draws(seed, device).normal(2**14, g_ema.style_dim)).mean(dim=0, keepdim=True)


def _eval_swd(g_ema, reals: np.ndarray, batch: int, seed: int, step: int, device) -> dict:
    """SWD of len(reals) EMA samples (truncation 1, stored noise; z from
    Draws(seed + 7 + step)) against the reals."""
    from ..eval.cli import make_fid_sampler
    from ..eval.swd import swd

    synth = make_fid_sampler(g_ema, _eval_mean_latent(g_ema, seed, device))
    draws = Draws(seed + 7 + step, device)
    fakes = []
    for start in range(0, len(reals), batch):
        fakes.append(synth(draws, batch, 1.0)[: min(batch, len(reals) - start)].float().cpu().numpy())
    return swd(reals, np.concatenate(fakes))


def _eval_fid(g_ema, feats, real_stats, n_sample: int, batch: int, seed: int, device) -> dict:
    """FID of n_sample EMA samples under the reference's truncation protocol
    (U(0.9, 1.5) per batch toward the mean latent; z from Draws(0))."""
    from ..eval.cli import make_fid_sampler
    from ..eval.metrics import fid

    synth = make_fid_sampler(g_ema, _eval_mean_latent(g_ema, seed, device))
    return fid(synth, feats, real_stats, n_sample=n_sample, batch_size=batch, draws=Draws(0, device))


def train_loop(args) -> Optional[TrainState]:
    """Train from parsed arguments; returns the final state (None with
    --print_config)."""
    # rendezvous first: the process group decides this process's card
    multiprocess = maybe_initialize_distributed(args.coordinator, args.num_processes, args.process_id, args.device)
    try:
        return _train(args, multiprocess)
    finally:
        if multiprocess:
            shutdown_distributed()


def _train(args, multiprocess: bool) -> Optional[TrainState]:
    device = process_device(args.device)
    main_process = is_main_process()
    if multiprocess:
        print(f"distributed: process {process_index()}/{process_count()} on {device}", flush=True)
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
        ada_target=args.ada_target,
        ada_length=args.ada_length,
        lookahead=args.lookahead,
        la_steps=args.la_steps,
        la_alpha=args.la_alpha,
        bcr_weight=args.balanced_consistency,
        contrastive_weight=args.contrastive,
        contrastive_momentum=args.contrastive_momentum,
        contrastive_queue=args.contrastive_queue,
        bf16=args.bf16,
        s2d_min_res=args.s2d_min_res,
        # the JAX CLI's rules: the 1x-grid warp from 512^2 on; `auto` is the
        # FFT-shear warp on the card (decided by the training device) and
        # the gather warp ("conv") on the CPU
        ada_fast_warp=args.size >= 512 if args.ada_fast_warp < 0 else bool(args.ada_fast_warp),
        ada_warp_method=(
            (None if device.type == "cpu" else "fft") if args.ada_warp == "auto" else (args.ada_warp or None)
        ),
        ada_fft_taper=args.ada_fft_taper if args.ada_fft_taper > 0 else None,
        ada_fft_taper_conditional=not args.ada_fft_taper_always,
        # the same automatic rules as the JAX CLI, with or without a
        # coordinator: chunk the lazy regularizers into stddev-group-sized
        # pieces and rematerialise the G synthesis from 512^2 on, where their
        # peak memory bounds the batch
        reg_chunks=(args.reg_chunks if args.reg_chunks > 0
                    else (max(1, args.batch_size // 4) if args.size >= 512 else 1)),
        remat_synth=args.remat_synth > 0 if args.remat_synth >= 0 else args.size >= 512,
    )
    if args.print_config:
        print(json.dumps(cfg._asdict()))
        return None
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
    if main_process:
        os.makedirs(args.run_dir, exist_ok=True)
    wandb_run = init_wandb(args) if args.wandb and main_process else None
    sample_z = torch.from_numpy(
        np.random.default_rng(args.seed + 1).standard_normal((args.n_sample, cfg.latent_dim), dtype=np.float32)
    ).to(device)
    draw_gen = torch.Generator(device=device).manual_seed(args.seed + 2)

    # periodic eval of the EMA generator: SWD (weight-free) or FID
    swd_reals = real_stats = None
    if args.eval_every > 0 and multiprocess:
        print("eval-in-training is single-process only; skipping", flush=True)
    elif args.eval_every > 0 and args.eval_metric == "swd":
        reals = np.stack([dataset[i] for i in range(min(args.swd_n_sample, len(dataset)))])
        if reals.dtype == np.uint8:  # uint8 HWC records
            reals = reals.transpose(0, 3, 1, 2).astype(np.float32) / 127.5 - 1.0
        swd_reals = reals
    elif args.eval_every > 0 and args.inception_stats:
        import pickle

        from ..eval.cli import _feature_net

        eval_feats, eval_pretrained, eval_fingerprint = _feature_net(args.inception_weights, args.fid_inception, device)
        with open(args.inception_stats, "rb") as f:
            real_stats = pickle.load(f)

    monitor = trace_ctx = spec_state = None
    if args.monitor and main_process:
        monitor = DeviceMonitor(os.path.join(args.run_dir, "gpumon.jsonl"), wandb_run=wandb_run).start()
    if args.profile and main_process:
        trace_ctx = profile_trace(os.path.join(args.run_dir, "trace"))
        trace_ctx.__enter__()
    if args.log_spec_norm:
        spec_state = {"G": init_spectral_state(state.g), "D": init_spectral_state(state.d)}

    counts = {"fused_bias_act launches": 0, "fused_bias_act_grad launches": 0}
    metrics_file = open(os.path.join(args.run_dir, "metrics.jsonl"), "a") if main_process else None
    try:
        t_last = time.time()
        start = state.step
        for i in range(start, args.iter):
            real = next(loader)
            draws = draw_step(cfg, state.step, draw_gen, device)
            before = (fused_act.launches, fused_act.grad_launches)
            metrics = step_fn(state, real, draws)
            counts["fused_bias_act launches"] += fused_act.launches - before[0]
            counts["fused_bias_act_grad launches"] += fused_act.grad_launches - before[1]
            if trace_ctx is not None and i - start >= args.profile_iters:
                trace_ctx.__exit__(None, None, None)
                trace_ctx = None

            if i % args.log_every == 0:
                log = {k: float(v) for k, v in metrics.items()}  # synchronises the step
                if spec_state is not None:
                    for net, module in (("G", state.g), ("D", state.d)):
                        sigmas, spec_state[net] = spectral_norms(module, spec_state[net])
                        log.update({f"{net} {k}": v for k, v in summarize(sigmas).items()})
                log["step"] = i
                log["sec_per_iter"] = (time.time() - t_last) / max(args.log_every, 1)
                log.update(counts)
                counts = dict.fromkeys(counts, 0)
                if main_process:
                    print(json.dumps({k: round(v, 5) if isinstance(v, float) else v for k, v in log.items()}), flush=True)
                    metrics_file.write(json.dumps(log) + "\n")
                    metrics_file.flush()
                    if wandb_run is not None:
                        wandb_run.log(log, step=i)
                t_last = time.time()

            if main_process and args.img_every > 0 and i % args.img_every == 0:
                with torch.no_grad():
                    imgs, _ = state.g_ema(sample_z, randomize_noise=False)
                save_image_grid(imgs.cpu().numpy(), os.path.join(args.run_dir, f"samples/{i:07d}.png"))

            if args.eval_every > 0 and i > 0 and i % args.eval_every == 0 and (swd_reals is not None or real_stats is not None):
                t_eval, launched = time.time(), fused_act.launches
                with torch.no_grad():
                    if swd_reals is not None:
                        scores = _eval_swd(state.g_ema, swd_reals, args.fid_batch, args.seed, i, device)
                        key, value = "SWD", scores["swd_avg"]
                    else:
                        scores = _eval_fid(state.g_ema, eval_feats, real_stats, args.fid_n_sample, args.fid_batch,
                                           args.seed, device)
                        scores.update(pretrained=eval_pretrained, weights_fingerprint=eval_fingerprint)
                        key, value = "FID", scores["fid"]
                scores.update({key: value, "step": i, "eval_seconds": time.time() - t_eval,
                               "fused_bias_act launches": fused_act.launches - launched})
                print(json.dumps({key: value, "step": i}), flush=True)
                metrics_file.write(json.dumps(scores) + "\n")
                metrics_file.flush()
                if wandb_run is not None:
                    wandb_run.log({key: value}, step=i)

            if main_process and args.checkpoint_every > 0 and i > 0 and i % args.checkpoint_every == 0:
                save_checkpoint(args.run_dir, state, step=i)
        if main_process:
            save_checkpoint(args.run_dir, state)
    finally:
        loader.close()
        if metrics_file is not None:
            metrics_file.close()
        if monitor is not None:
            monitor.stop()
        if trace_ctx is not None:
            trace_ctx.__exit__(None, None, None)
        if wandb_run is not None:
            wandb_run.finish()
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
    p.add_argument("--augment", action="store_true", default=True, help="ADA augmentation (default on)")
    p.add_argument("--no-augment", dest="augment", action="store_false")
    p.add_argument("--augment_p", type=float, default=0.0)
    p.add_argument("--ada_target", type=float, default=0.6, help="ADA's target r_t")
    p.add_argument("--ada_length", type=float, default=15_000, help="real predictions for p to move by the target")
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
                   help="ADA warp: auto = fft on a CUDA device, the gather warp on the CPU; '' = by --ada_fast_warp")
    p.add_argument("--ada_fft_taper", type=float, default=0.85,
                   help="fft warp: band taper from this fraction of Nyquist (0 = off)")
    p.add_argument("--ada_fft_taper_always", action="store_true",
                   help="fft warp: taper every row, not only fractionally shifted ones")
    p.add_argument("--ada_fast_warp", type=int, default=-1,
                   help="1x-output-grid matmul warp (1/0); -1 = auto (on at >=512^2)")
    p.add_argument("--contrastive", type=float, default=0.0)
    p.add_argument("--contrastive_momentum", type=float, default=0.0,
                   help="MoCo key encoder momentum (0 = keys through D itself)")
    p.add_argument("--contrastive_queue", type=int, default=0,
                   help="MoCo queue of past keys as negatives (a multiple of 2 x batch; 0 = none)")
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
    p.add_argument("--eval_every", type=int, default=0, help="metric interval (0 = off)")
    p.add_argument("--eval_metric", type=str, default="fid", choices=["fid", "swd"],
                   help="fid needs --inception_stats (from eval.cli inception); swd is weight-free")
    p.add_argument("--swd_n_sample", type=int, default=256, help="real/fake set size for --eval_metric swd")
    p.add_argument("--inception_stats", type=str, default=None, help="pkl from eval.cli inception")
    p.add_argument("--inception_weights", type=str, default=None)
    p.add_argument("--fid_inception", action="store_true", help="inception_weights are pytorch-fid pt_inception")
    p.add_argument("--fid_n_sample", type=int, default=2500)
    p.add_argument("--fid_batch", type=int, default=6)
    p.add_argument("--profile", action="store_true", help="torch.profiler trace of the first steps into <run_dir>/trace")
    p.add_argument("--profile_iters", type=int, default=5)
    p.add_argument("--monitor", action="store_true", help="background device-memory / RSS monitor to gpumon.jsonl")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of process 0 for a data-parallel run (torch.distributed over tcp://)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p


def main(argv=None) -> int:
    train_loop(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""VAE hyperparameter-sweep entry point (counterpart of maua_tpu/train/vae_cli.py;
the reference's accelerate/accelerate_logcosh.py:87-229): one VAE trained
with an optional perceptual loss, the final "Score" logged (27000 on
divergence or when no batch fits, with out-of-memory batch halving).

    python -m maua_tpu_torch.train.vae_cli --path shards/ --size 64 --model logcosh \\
        --latent_dim 512 --learning_rate 1e-3 --vae_alpha 10 --vae_beta 1 [--device cpu]

The JAX CLI's flags, plus `--device` (default cuda) and `--save` (write the
trained model's state dict there, the `--vae_ckpt` of
`python -m maua_tpu_torch.data.prepare_vae_codes`). Each logged step prints
one JSON line of the losses with `step` and `elapsed`; the last line is
{"Score": ..., "failed": ...}. `--wandb` logs there too when wandb imports,
and a sweep agent's wandb.config overrides the flags of the same names;
without wandb the trial runs standalone. The logcosh model trains only at
`--size 2**(n_layers + 1)` (64 for the default 5 layers): it decodes to that
size whatever its input, so any other size raises ValueError before the
first step.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import resolve_device
from ..draws import Draws
from .vae import FAILURE_SCORE, make_perceptual_loss, sweep_trial

__all__ = ["build_model", "build_parser", "main", "make_data_fn", "run_trial"]


def build_model(args, device):
    from ..models.autoencoder import InceptionVAE, LogCoshVAE, VariationalConvSegNet

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        if args.model == "logcosh":
            hidden = tuple(int(args.number_filters) * (2**i) for i in range(args.n_layers))
            model = LogCoshVAE(size=args.size, latent_dim=int(args.latent_dim), hidden_dims=hidden,
                               alpha=float(args.vae_alpha), beta=float(args.vae_beta),
                               kld_weight=float(args.kl_divergence_weight))
        elif args.model == "inception":
            model = InceptionVAE(size=args.size, latent_dim=int(args.latent_dim), base=int(args.number_filters))
        elif args.model == "segnet":
            model = VariationalConvSegNet(size=args.size)
        else:
            raise ValueError(f"unknown --model {args.model}")
    return model.to(device)


def check_size(args) -> None:
    if args.model == "logcosh" and args.size != 2 ** (args.n_layers + 1):
        raise ValueError(
            f"--model logcosh decodes to {2 ** (args.n_layers + 1)}^2 whatever the input size, so with "
            f"--n_layers {args.n_layers} it trains only at --size {2 ** (args.n_layers + 1)} (got --size {args.size})"
        )


def make_data_fn(path: str, size: int, seed: int, device):
    """data_fn(batch) -> an endless iterator of [batch, 3, size, size] fp32
    batches on `device`, records drawn uniformly with replacement from a
    numpy RandomState(seed)."""
    from ..data import MultiResolutionRecordDataset

    dataset = MultiResolutionRecordDataset(path, resolution=size)

    def data_fn(batch_size: int):
        rng = np.random.RandomState(seed)

        def gen():
            while True:
                idx = rng.randint(0, len(dataset), size=batch_size)
                yield torch.from_numpy(np.stack([dataset[int(i)] for i in idx])).to(device)

        return gen()

    return data_fn


def run_trial(args, wandb_run=None) -> float:
    device = resolve_device(args.device)
    check_size(args)
    data_fn = make_data_fn(args.path, args.size, args.seed, device)

    perceptual = None
    if args.perceptual_weight > 0:
        backbone_sd = None
        if args.vgg_weights:
            sd = torch.load(args.vgg_weights, map_location="cpu", weights_only=False)
            backbone_sd = {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}
        perceptual = make_perceptual_loss(backbone_sd, image_size=args.size, device=device)

    def on_log(entry: dict) -> None:
        print(json.dumps(entry), flush=True)
        if wandb_run is not None:
            wandb_run.log(entry)

    score, state = sweep_trial(
        lambda: build_model(args, device),
        data_fn,
        batch_size=args.batch_size,
        n_steps=args.iter,
        lr=args.learning_rate,
        perceptual_weight=args.perceptual_weight,
        perceptual_loss=perceptual,
        draws=Draws(args.seed, device),
        on_log=on_log,
    )
    if args.save and state is not None:
        torch.save(state, args.save)
    print(json.dumps({"Score": score, "failed": score >= FAILURE_SCORE}), flush=True)
    if wandb_run is not None:
        wandb_run.log({"Score": score})
    return score


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="VAE sweep trial (reference: accelerate_logcosh.py)")
    p.add_argument("--path", required=True, help=".mrec shard directory")
    p.add_argument("--device", type=str, default=None, help="torch device (default cuda)")
    p.add_argument("--model", choices=["logcosh", "inception", "segnet"], default="logcosh")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--iter", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    # swept hyperparameters (names mirror the reference sweep config)
    p.add_argument("--latent_dim", type=int, default=512)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--number_filters", type=int, default=32)
    p.add_argument("--n_layers", type=int, default=5)
    p.add_argument("--vae_alpha", type=float, default=10.0)
    p.add_argument("--vae_beta", type=float, default=1.0)
    p.add_argument("--kl_divergence_weight", type=float, default=1.0)
    p.add_argument("--perceptual_weight", type=float, default=0.0)
    p.add_argument("--vgg_weights", type=str, default=None, help="torchvision vgg16 state dict for the perceptual loss")
    p.add_argument("--save", type=str, default=None, help="write the trained model's state dict here")
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--wandb_project", type=str, default="maua-stylegan")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    wandb_run = None
    if args.wandb:
        try:
            import wandb

            wandb_run = wandb.init(project=args.wandb_project, config=vars(args))
            # under a sweep agent wandb.config carries the swept values, which
            # override the flags (reference: train(**wandb.config))
            for k, v in dict(wandb_run.config).items():
                if hasattr(args, k):
                    setattr(args, k, v)
        except Exception as e:  # no wandb, no login, no network: the trial runs standalone
            print(f"wandb unavailable ({e}); running standalone", flush=True)
    try:
        run_trial(args, wandb_run)
    finally:
        if wandb_run is not None:
            wandb_run.finish()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

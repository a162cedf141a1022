"""Standalone metric CLIs (counterpart of maua_tpu/eval/cli.py).

    python -m maua_tpu_torch.eval.cli inception --path shards/ --size 256 --out stats.pkl
    python -m maua_tpu_torch.eval.cli fid --ckpt g.pt --stats stats.pkl --n_sample 50000
    python -m maua_tpu_torch.eval.cli ppl --ckpt g.pt --n_sample 5000 [--lpips_weights vgg16.pth]

Every subcommand takes `--device` (default cuda) and `--precision` (exact:
TF32 off, the default; fast: TF32 on in the feature networks and the
generator's large convs). `ppl` runs exact only and raises ValueError under
fast: TF32's rounding swamps the image differences it divides by eps^2.
InceptionV3 weights: `--inception_weights` at a
torchvision inception_v3 state dict, with `--fid_inception` for a
pytorch-fid pt_inception one; without them the network is random from seed 0
and the JSON says so (`calibrated`, `pretrained` false, and the weights'
fingerprint). Each prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import pickle

import numpy as np
import torch

from ..device import resolve_device
from ..draws import Draws

__all__ = ["main"]


def _load_state_dict(path: str) -> dict:
    """A state dict from a torch file (a module's, when the file holds one).
    Full unpickling: load only files you trust."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def _feature_net(weights_path: str | None, fid_variant: bool = False, device=None, precision: str = "exact"):
    """(feats(images) -> [N, 2048] on the device, calibrated, weights
    fingerprint). Images: [-1, 1] NCHW of any size, tensors or numpy."""
    from .inception import InceptionV3
    from .metrics import weights_fingerprint

    device = resolve_device(device)
    net = InceptionV3(fid_variant=fid_variant, precision=precision)
    calibrated = weights_path is not None
    if calibrated:
        net.load(_load_state_dict(weights_path))
    net = net.requires_grad_(False).eval().to(device)

    def feats(img):
        x = torch.as_tensor(img).to(device=device, dtype=torch.float32)
        return net(InceptionV3.preprocess(x))

    return feats, calibrated, weights_fingerprint(net.state_dict())


def cmd_inception(args) -> int:
    from ..data import MultiResolutionRecordDataset
    from .metrics import cached_dataset_stats

    feats, calibrated, fingerprint = _feature_net(args.inception_weights, args.fid_inception, args.device, args.precision)
    ds = MultiResolutionRecordDataset(args.path, resolution=args.size)

    def batches():
        batch = []
        for i in range(len(ds)):
            batch.append(ds[i])
            if len(batch) == args.batch:
                yield np.stack(batch)
                batch = []
        if batch:
            yield np.stack(batch)

    stats = cached_dataset_stats(feats, batches(), args.out, max_items=args.n_sample)
    print(json.dumps({
        "n_features": int(stats[0].shape[0]), "calibrated": calibrated,
        "pretrained": calibrated, "weights_fingerprint": fingerprint, "out": args.out,
    }))
    return 0


def make_fid_sampler(gen, mean_w):
    """synthesize(draws, batch, trunc): z from draws, truncated toward
    mean_w by trunc for every sample, stored noise."""

    def synthesize(draws, batch, trunc):
        z = draws.normal(batch, gen.style_dim)
        img, _ = gen(z, truncation=torch.full((batch,), float(trunc), device=z.device),
                     truncation_latent=mean_w, randomize_noise=False)
        return img

    return synthesize


def cmd_fid(args) -> int:
    from ..io.torch_ckpt import load_generator
    from .metrics import fid

    device = resolve_device(args.device)
    gen = load_generator(args.ckpt, device=device, precision=args.precision)
    feats, calibrated, fingerprint = _feature_net(args.inception_weights, args.fid_inception, device, args.precision)
    # the reference's sampling protocol: truncation toward the mean of 2^14
    # mapped z (from seed 0), U(0.9, 1.5) per batch unless fixed
    with torch.no_grad():
        mean_w = gen.get_latent(Draws(0, device).normal(2**14, gen.style_dim)).mean(dim=0, keepdim=True)
    with open(args.stats, "rb") as f:
        real_stats = pickle.load(f)
    out = fid(make_fid_sampler(gen, mean_w), feats, real_stats, n_sample=args.n_sample, batch_size=args.batch,
              draws=Draws(1, device), truncation=args.truncation)
    out["calibrated_features"] = calibrated
    out["pretrained"] = calibrated
    out["weights_fingerprint"] = fingerprint
    out["feature_net"] = ("fid-inception" if args.fid_inception else "torchvision-inception") + ("" if calibrated else "-random")
    out["truncation"] = args.truncation if args.truncation is not None else "U(0.9,1.5)"
    print(json.dumps(out))
    return 0


def multiscale_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean squared difference at strides 1, 2 and 4, summed: PPL's
    perceptual proxy when no LPIPS weights are given."""
    total = torch.zeros(a.shape[0], device=a.device)
    for s in (1, 2, 4):
        total = total + (a[:, :, ::s, ::s] - b[:, :, ::s, ::s]).square().mean(dim=(1, 2, 3))
    return total


def cmd_ppl(args) -> int:
    from ..io.torch_ckpt import load_generator
    from .metrics import ppl, weights_fingerprint

    if args.precision != "exact":
        raise ValueError(
            "ppl runs exact only: TF32's ~1e-3 relative rounding swamps the ~1e-4 image differences that PPL "
            "divides by eps^2 (--precision fast made the PPL 26.8x too large on an H100)"
        )
    device = resolve_device(args.device)
    gen = load_generator(args.ckpt, device=device, precision=args.precision)

    def map_latents(draws, n):
        return gen.get_latent(draws.normal(n, gen.style_dim))

    def synthesize_from_w(w):
        img, _ = gen(w[:, None, :].repeat(1, gen.n_latent, 1), input_is_latent=True, randomize_noise=False)
        return img

    if args.lpips_weights:
        from .lpips import perceptual_lpips

        sd = {k: v.numpy() for k, v in _load_state_dict(args.lpips_weights).items() if hasattr(v, "numpy")}
        dist = perceptual_lpips(sd, net="vgg", device=device, precision=args.precision)  # per-pair distances
        dist_name = "lpips-vgg"
        fingerprint: str | None = weights_fingerprint(sd)
    else:
        dist, dist_name, fingerprint = multiscale_l2, "multiscale-l2-proxy", None

    val = ppl(synthesize_from_w, map_latents, dist, n_sample=args.n_sample, batch_size=args.batch, crop=args.crop,
              draws=Draws(0, device))
    # comparable to published PPLs only when distance is lpips-vgg
    print(json.dumps({
        "ppl": val, "distance": dist_name,
        "pretrained": args.lpips_weights is not None,
        "weights_fingerprint": fingerprint,
    }))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="standalone eval metrics")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, precision_help="exact: TF32 off; fast: TF32 on in the feature nets and the large convs"):
        sp.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
        sp.add_argument("--precision", choices=["exact", "fast"], default="exact", help=precision_help)

    pi = sub.add_parser("inception", help="precompute dataset feature stats")
    pi.add_argument("--path", required=True)
    pi.add_argument("--size", type=int, default=256)
    pi.add_argument("--batch", type=int, default=16)
    pi.add_argument("--n_sample", type=int, default=None)
    pi.add_argument("--out", type=str, required=True)
    pi.add_argument("--inception_weights", type=str, default=None)
    pi.add_argument("--fid_inception", action="store_true", help="weights are pytorch-fid pt_inception (FIDInception pools)")
    common(pi)

    pf = sub.add_parser("fid", help="FID of a checkpoint vs cached stats")
    pf.add_argument("--ckpt", required=True)
    pf.add_argument("--stats", required=True)
    pf.add_argument("--n_sample", type=int, default=50_000)
    pf.add_argument("--batch", type=int, default=64)
    pf.add_argument("--inception_weights", type=str, default=None)
    pf.add_argument("--fid_inception", action="store_true", help="weights are pytorch-fid pt_inception (FIDInception pools)")
    pf.add_argument("--truncation", type=float, default=None,
                    help="fixed truncation; default draws U(0.9,1.5) per batch (reference protocol)")
    common(pf)

    pp = sub.add_parser("ppl", help="perceptual path length")
    pp.add_argument("--ckpt", required=True)
    pp.add_argument("--n_sample", type=int, default=5000)
    pp.add_argument("--batch", type=int, default=16)
    pp.add_argument("--crop", action="store_true")
    pp.add_argument("--lpips_weights", type=str, default=None, help="torchvision vgg16 state dict")
    common(pp, "exact only: fast raises ValueError (TF32's rounding swamps the eps = 1e-4 image differences "
               "that PPL divides by eps^2)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return {"inception": cmd_inception, "fid": cmd_fid, "ppl": cmd_ppl}[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())

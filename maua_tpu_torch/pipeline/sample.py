"""Sample images from a checkpoint's g_ema, with truncation, as PNGs and a
contact sheet (counterpart of maua_tpu/pipeline/sample.py).

    python -m maua_tpu_torch.pipeline.sample --ckpt g.pt --pics 16 --truncation 0.7 [--device cpu]

Draws: each batch's z [sample_batch, D] from `draws` (default `Draws(seed)`);
with truncation < 1 the mean latent's z [truncation_mean, D] from
`mean_draws` (default `Draws(seed + 1)`).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..draws import Draws
from ..io.torch_ckpt import load_generator
from ..train.cli import save_image_grid

__all__ = ["main", "sample"]


def sample(
    ckpt: str,
    pics: int = 20,
    sample_batch: int = 8,
    truncation: float = 1.0,
    truncation_mean: int = 2**14,
    out_dir: str = "sample",
    seed: int = 0,
    grid: bool = True,
    device: DeviceLike = None,
    draws=None,
    mean_draws=None,
) -> str:
    """Write `pics` PNGs (000000.png, ...) and grid.png to `out_dir`; returns
    its absolute path. Runs on `device` (default `cuda`)."""
    from PIL import Image

    device = resolve_device(device)
    gen = load_generator(ckpt, device=device)
    draws = Draws(seed, device) if draws is None else draws
    mean_w = None
    with torch.inference_mode():
        if truncation < 1.0:
            mean_draws = Draws(seed + 1, device) if mean_draws is None else mean_draws
            mean_w = gen.get_latent(mean_draws.normal(truncation_mean, gen.style_dim).to(device)).mean(dim=0, keepdim=True)
        os.makedirs(out_dir, exist_ok=True)
        imgs = []
        done = 0
        while done < pics:
            z = draws.normal(sample_batch, gen.style_dim).to(device)
            img, _ = gen(z, truncation=truncation, truncation_latent=mean_w, randomize_noise=False)
            batch = img.cpu().numpy()
            take = min(sample_batch, pics - done)
            for i in range(take):
                arr = ((np.clip(batch[i], -1, 1) + 1) * 127.5).astype(np.uint8).transpose(1, 2, 0)
                Image.fromarray(arr).save(os.path.join(out_dir, f"{done + i:06d}.png"))
            imgs.append(batch[:take])
            done += take
    if grid:
        save_image_grid(np.concatenate(imgs), os.path.join(out_dir, "grid.png"))
    return os.path.abspath(out_dir)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="sample images from a checkpoint")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--pics", type=int, default=20)
    p.add_argument("--sample_batch", type=int, default=8)
    p.add_argument("--truncation", type=float, default=1.0)
    p.add_argument("--truncation_mean", type=int, default=2**14)
    p.add_argument("--out_dir", type=str, default="sample")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    sample(a.ckpt, a.pics, a.sample_batch, a.truncation, a.truncation_mean, a.out_dir, a.seed, device=a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Encode a record dataset through a trained LogCoshVAE and store the codes
as a new record dataset (counterpart of maua_tpu/data/prepare_vae_codes.py;
the reference's prepare_vae_codes.py:15-80).

    python -m maua_tpu_torch.data.prepare_vae_codes --path shards/ --size 128 \\
        --vae_ckpt vae.pt --out codes/ [--device cpu]

Each code is `mu` of the encoder, pickled as a float32 numpy array into
`<out>/codes-0-<shard>.mrec` shards of `shard_size` records: the JAX
package's format, byte for byte for the same codes. As there, the encoder
runs in training mode (batch statistics of each batch of `batch` images) and
the last batch is padded with repeats of its last image, which changes that
batch's statistics; the model's running statistics are left as they were.
`--vae_ckpt` is a state dict of the port's LogCoshVAE (`vae_cli --save`);
without it the weights are random from seed 0.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.blocks import tf32
from .records import MultiResolutionRecordDataset, RecordShardWriter

__all__ = ["encode_dataset", "main", "write_code_shards"]


def write_code_shards(codes, out_dir: str, shard_size: int = 4096, name: str = "codes") -> int:
    """Pickle each [D] code (as float32) into `<name>-0-<i>.mrec` shards of
    `shard_size` records; returns the number written."""
    os.makedirs(out_dir, exist_ok=True)
    written = 0
    for shard_idx, start in enumerate(range(0, len(codes), shard_size)):
        with RecordShardWriter(os.path.join(out_dir, f"{name}-0-{shard_idx:04d}.mrec")) as writer:
            for code in codes[start : start + shard_size]:
                writer.append(pickle.dumps(np.asarray(code).astype(np.float32)))
                written += 1
    return written


@torch.no_grad()
def encode(model: torch.nn.Module, path: str, size: int, batch: int = 16) -> np.ndarray:
    """mu [N, D] of every record, in training mode batch by batch, the last
    batch padded with repeats of its last image."""
    ds = MultiResolutionRecordDataset(path, resolution=size)
    device = next(model.parameters()).device
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    was_training = model.training
    model.train()
    codes = []
    try:
        with tf32(conv=False, matmul=False):
            for start in range(0, len(ds), batch):
                imgs = np.stack([ds[i] for i in range(start, min(start + batch, len(ds)))])
                n = len(imgs)
                if n < batch:
                    imgs = np.concatenate([imgs, imgs[-1:].repeat(batch - n, 0)])
                mu, _ = model.encode(torch.from_numpy(imgs).to(device))
                codes.append(mu[:n].float().cpu().numpy())
    finally:
        for k, v in model.named_buffers():
            v.copy_(buffers[k])
        model.train(was_training)
    return np.concatenate(codes) if codes else np.zeros((0, 0), np.float32)


def encode_dataset(model: torch.nn.Module, path: str, size: int, out_dir: str, batch: int = 16,
                   shard_size: int = 4096, name: str = "codes") -> int:
    """Encode every image of `path` at `size` and write the codes; returns
    how many were written."""
    return write_code_shards(encode(model, path, size, batch), out_dir, shard_size, name)


def load_vae(ckpt, size: int, latent_dim: int, device: DeviceLike = None) -> torch.nn.Module:
    """LogCoshVAE(size, latent_dim) on `device`, with `ckpt`'s state dict or
    random weights from seed 0."""
    from ..models.autoencoder import LogCoshVAE

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = LogCoshVAE(size=size, latent_dim=latent_dim)
    if ckpt:
        model.load_state_dict(torch.load(ckpt, map_location="cpu", weights_only=True))
    return model.to(resolve_device(device))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="encode a dataset to VAE codes")
    p.add_argument("--path", required=True)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--latent_dim", type=int, default=512)
    p.add_argument("--vae_ckpt", type=str, default=None, help="state dict of the port's LogCoshVAE (vae_cli --save)")
    p.add_argument("--device", type=str, default=None, help="torch device (default cuda)")
    args = p.parse_args(argv)

    model = load_vae(args.vae_ckpt, args.size, args.latent_dim, args.device)
    n = encode_dataset(model, args.path, args.size, args.out, args.batch)
    print(f"encoded {n} codes -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

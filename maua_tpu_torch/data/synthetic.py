"""Synthetic image datasets for convergence/throughput experiments (the port's
own copy of maua_tpu/data/synthetic.py; the same images from the same seed).

Generates structured random images: each sample composites
1-3 oriented sinusoidal stripe systems and a few radial blobs in random
colors on a random low-frequency background. The set has real learnable
structure (orientation/frequency/color statistics) while needing no external
data — the reference trains on user-supplied LMDB images
(reference: dataset.py:10-42); this module exists so training runs are
reproducible in a data-free environment.

CLI:  python -m maua_tpu_torch.data.synthetic --out DIR --size 1024 --n 128 \
          --format raw [--seed 0]
writes `<name>-<size>-00000.mrec` shards (records.py; v2 raw = zero-decode
loader fast path) ready for `maua_tpu_torch.train.cli --path DIR --size SIZE --no-augment`.
"""

from __future__ import annotations

import numpy as np


def synth_image(rng: np.random.Generator, size: int) -> np.ndarray:
    """One [size, size, 3] uint8 RGB sample: low-freq background + 1-3
    oriented stripe systems + 0-4 radial blobs, random colors."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size

    bg = rng.uniform(0.1, 0.9, size=3).astype(np.float32)
    img = np.ones((size, size, 3), np.float32) * bg
    # low-frequency gradient tint
    gdir = rng.normal(size=2).astype(np.float32)
    g = (xx * gdir[0] + yy * gdir[1]) * rng.uniform(0.05, 0.3)
    img += g[..., None] * rng.uniform(-1, 1, size=3).astype(np.float32)

    for _ in range(rng.integers(1, 4)):
        theta = rng.uniform(0, np.pi)
        freq = rng.uniform(3, 18)
        phase = rng.uniform(0, 2 * np.pi)
        wave = np.sin(
            2 * np.pi * freq * (np.cos(theta) * xx + np.sin(theta) * yy) + phase
        )
        mask = (wave > rng.uniform(-0.3, 0.6)).astype(np.float32)
        color = rng.uniform(0, 1, size=3).astype(np.float32)
        alpha = rng.uniform(0.25, 0.8)
        img = img * (1 - alpha * mask[..., None]) + color * (alpha * mask[..., None])

    for _ in range(rng.integers(0, 5)):
        cx, cy = rng.uniform(0.1, 0.9, size=2)
        r = rng.uniform(0.04, 0.22)
        d2 = (xx - cx) ** 2 + (yy - cy) ** 2
        blob = np.exp(-d2 / (2 * (r / 2) ** 2)).astype(np.float32)
        color = rng.uniform(0, 1, size=3).astype(np.float32)
        img = img * (1 - blob[..., None]) + color * blob[..., None]

    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def write_synth_shards(
    out_dir: str,
    size: int,
    n: int,
    fmt: str = "raw",
    seed: int = 0,
    name: str = "data",
    shard_size: int = 1024,
    quality: int = 95,
) -> int:
    """Write n synthetic samples as .mrec shards; returns n."""
    import os

    from .records import RecordShardWriter

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    written = 0
    shard = 0
    while written < n:
        take = min(shard_size, n - written)
        path = os.path.join(out_dir, f"{name}-{size}-{shard:05d}.mrec")
        with RecordShardWriter(path, fmt=fmt, side=size if fmt == "raw" else 0) as w:
            for _ in range(take):
                img = synth_image(rng, size)
                if fmt == "raw":
                    w.append(img)
                else:
                    import cv2

                    ok, buf = cv2.imencode(
                        ".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                        [cv2.IMWRITE_JPEG_QUALITY, quality],
                    )
                    if not ok:
                        raise RuntimeError("jpeg encode failed")
                    w.append(buf.tobytes())
        written += take
        shard += 1
    return written


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="synthetic stripe/blob dataset -> record shards")
    p.add_argument("--out", required=True)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--format", type=str, default="raw", choices=["jpeg", "raw"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--name", type=str, default="data")
    p.add_argument("--shard_size", type=int, default=1024)
    args = p.parse_args(argv)
    n = write_synth_shards(
        args.out, args.size, args.n, fmt=args.format, seed=args.seed,
        name=args.name, shard_size=args.shard_size,
    )
    print(f"wrote {n} {args.size}x{args.size} {args.format} records to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

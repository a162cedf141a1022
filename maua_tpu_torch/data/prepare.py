"""prepare_data: image folder -> multi-resolution record shards (the port's
own copy of maua_tpu/data/prepare.py).

Centre-crop and resize to each side (128, 256, 512, 1024 by default) with
OpenCV, JPEG-encode at quality 100 (or store raw RGB), and write MREC shards
with the port's `data/records.py`, one shard per chunk of images, chunks
spread over worker processes. The shards are byte-equal to the JAX
package's.

    python -m maua_tpu_torch.data.prepare images/ --out shards/ --sizes 256
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Sequence

import numpy as np

from .records import RecordShardWriter

__all__ = ["main", "prepare_data", "reencode_raw"]

IMG_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tiff"}


def _list_images(folder: str) -> list[str]:
    out = []
    for root, _, files in os.walk(folder):
        for f in sorted(files):
            if os.path.splitext(f)[1].lower() in IMG_EXTENSIONS:
                out.append(os.path.join(root, f))
    return sorted(out)


def _center_crop_resize(img: np.ndarray, size: int) -> np.ndarray:
    import cv2

    h, w = img.shape[:2]
    s = min(h, w)
    top, left = (h - s) // 2, (w - s) // 2
    img = img[top : top + s, left : left + s]
    interp = cv2.INTER_AREA if s > size else cv2.INTER_LANCZOS4
    return cv2.resize(img, (size, size), interpolation=interp)


def _process_chunk(task) -> list[str]:
    import cv2

    paths, sizes, out_dir, name, shard_idx, quality, fmt = task
    writers = {
        s: RecordShardWriter(
            os.path.join(out_dir, f"{name}-{s}-{shard_idx:04d}.mrec"), fmt=fmt, side=s
        )
        for s in sizes
    }
    for p in paths:
        img = cv2.imread(p, cv2.IMREAD_COLOR)
        if img is None:
            continue
        for s in sizes:
            resized = _center_crop_resize(img, s)
            if fmt == "raw":
                # pre-decoded records: RGB HWC uint8, which the loader reads
                # without decoding (records.py get_raw_hwc)
                writers[s].append(cv2.cvtColor(resized, cv2.COLOR_BGR2RGB))
            else:
                ok, buf = cv2.imencode(".jpg", resized, [cv2.IMWRITE_JPEG_QUALITY, quality])
                if ok:
                    writers[s].append(buf.tobytes())
    for w in writers.values():
        w.close()
    return [w.path for w in writers.values()]


def prepare_data(
    in_folder: str,
    out_dir: str,
    sizes: Sequence[int] = (128, 256, 512, 1024),
    n_workers: int = 8,
    shard_size: int = 1024,
    quality: int = 100,
    name: str = "data",
    fmt: str = "jpeg",
) -> int:
    """Convert an image folder into .mrec shards; returns the image count.
    fmt="raw" writes pre-decoded uint8 RGB records (v2 shards) that the
    loader reads with no decode work, for hosts whose training is bound by
    JPEG decoding."""
    os.makedirs(out_dir, exist_ok=True)
    paths = _list_images(in_folder)
    if not paths:
        raise FileNotFoundError(f"no images under {in_folder}")

    chunks = [paths[i : i + shard_size] for i in range(0, len(paths), shard_size)]
    tasks = [(chunk, tuple(sizes), out_dir, name, i, quality, fmt) for i, chunk in enumerate(chunks)]

    if n_workers <= 1 or len(tasks) == 1:
        for t in tasks:
            _process_chunk(t)
    else:
        with ProcessPoolExecutor(max_workers=n_workers, mp_context=multiprocessing.get_context("spawn")) as pool:
            list(pool.map(_process_chunk, tasks))
    return len(paths)


def reencode_raw(in_dir: str, out_dir: str, resolution: int, name: str = "data") -> int:
    """Re-encode existing JPEG .mrec shards at one resolution into raw (v2)
    shards, one output shard per input shard, record order preserved."""
    import glob as _glob

    import cv2

    from .records import RecordShardReader

    os.makedirs(out_dir, exist_ok=True)
    paths = sorted(_glob.glob(os.path.join(in_dir, f"*-{resolution}-*.mrec")))
    if not paths:
        raise FileNotFoundError(f"no shards for resolution {resolution} under {in_dir}")
    total = 0
    for shard_idx, p in enumerate(paths):
        reader = RecordShardReader(p)
        out = os.path.join(out_dir, f"{name}-{resolution}-{shard_idx:04d}.mrec")
        with RecordShardWriter(out, fmt="raw", side=resolution) as w:
            for i in range(len(reader)):
                buf = np.frombuffer(reader.get(i), dtype=np.uint8)
                img = cv2.imdecode(buf, cv2.IMREAD_COLOR)
                if img is None:
                    continue
                w.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
                total += 1
    return total


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="image folder -> multi-resolution record shards (maua_tpu_torch)")
    p.add_argument("folder")
    p.add_argument("--out", required=True)
    p.add_argument("--sizes", type=str, default="128,256,512,1024")
    p.add_argument("--n_workers", type=int, default=8)
    p.add_argument("--shard_size", type=int, default=1024)
    p.add_argument("--format", type=str, default="jpeg", choices=["jpeg", "raw"],
                   help="raw = pre-decoded uint8 records (no decoding when loading, "
                        "about 16x larger on disk)")
    args = p.parse_args(argv)
    n = prepare_data(
        args.folder, args.out, [int(s) for s in args.sizes.split(",")],
        args.n_workers, args.shard_size, fmt=args.format,
    )
    print(f"wrote {n} images")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

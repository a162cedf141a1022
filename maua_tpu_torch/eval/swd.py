"""Sliced Wasserstein Distance over Laplacian-pyramid patch descriptors
(the port's own copy of maua_tpu/eval/swd.py, numpy on the host).

The ProGAN evaluation metric (Karras et al. 2018, section 5 / appendix A):
compare real and generated image sets by the 1-D Wasserstein distance of
randomly projected 7x7x3 local patch descriptors, at every level of a
Laplacian pyramid from the image resolution down to 16x16. It needs no
pretrained feature network, so it is the weight-free trajectory metric of
`train.cli --eval_metric swd`. It runs once per eval interval on a few
hundred images and sorting dominates, so it stays on the host.
"""

from __future__ import annotations

import numpy as np

# binomial(4)/16 — the classic pyramid kernel
_PYR_K = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float64) / 16.0


def _blur_reflect(x: np.ndarray, axis: int) -> np.ndarray:
    """Separable 5-tap blur along `axis` with reflect padding. x: float64."""
    pad = [(0, 0)] * x.ndim
    pad[axis] = (2, 2)
    xp = np.pad(x, pad, mode="reflect")
    out = np.zeros_like(x)
    sl = [slice(None)] * x.ndim
    for i, k in enumerate(_PYR_K):
        sl[axis] = slice(i, i + x.shape[axis])
        out += k * xp[tuple(sl)]
    return out


def _blur(x: np.ndarray) -> np.ndarray:
    return _blur_reflect(_blur_reflect(x, -1), -2)


def laplacian_pyramid(imgs: np.ndarray, n_levels: int) -> list[np.ndarray]:
    """[N, C, H, W] -> n_levels bands, finest first; the last entry is the
    remaining low-pass. Downsampling is blur + 2x decimation."""
    levels = []
    cur = imgs.astype(np.float64)
    for _ in range(n_levels - 1):
        low = _blur(cur)[:, :, ::2, ::2]
        # upsample back: zero-stuff + 4x-gain blur
        up = np.zeros_like(cur)
        up[:, :, ::2, ::2] = low
        up = _blur(up) * 4.0
        levels.append(cur - up)
        cur = low
    levels.append(cur)
    return levels


def extract_patches(
    band: np.ndarray, patches_per_image: int, patch: int, rng: np.random.RandomState
) -> np.ndarray:
    """Random patch descriptors [N*per, C*patch*patch] from [N, C, H, W],
    channel-normalized over the set (ProGAN appendix A: subtract the mean and
    divide by the std of each color channel across all descriptors)."""
    n, c, h, w = band.shape
    ys = rng.randint(0, h - patch + 1, (n, patches_per_image))
    xs = rng.randint(0, w - patch + 1, (n, patches_per_image))
    out = np.empty((n, patches_per_image, c, patch, patch), np.float64)
    for i in range(n):
        for j in range(patches_per_image):
            out[i, j] = band[i, :, ys[i, j]:ys[i, j] + patch, xs[i, j]:xs[i, j] + patch]
    d = out.reshape(n * patches_per_image, c, patch * patch)
    mu = d.mean(axis=(0, 2), keepdims=True)
    sd = d.std(axis=(0, 2), keepdims=True)
    d = (d - mu) / (sd + 1e-8)
    return d.reshape(n * patches_per_image, c * patch * patch)


def sliced_wasserstein(
    a: np.ndarray, b: np.ndarray, n_dirs: int = 512, n_repeats: int = 4,
    rng: np.random.RandomState | None = None,
) -> float:
    """Mean 1-D Wasserstein distance over random unit projections of two
    descriptor sets [Na, D], [Nb, D] (Na == Nb required for the sort pairing)."""
    if rng is None:
        rng = np.random.RandomState(0)
    if a.shape != b.shape:
        raise ValueError(f"descriptor sets differ in shape: {a.shape} vs {b.shape}")
    total = 0.0
    for _ in range(n_repeats):
        dirs = rng.standard_normal((a.shape[1], n_dirs))
        dirs /= np.sqrt(np.sum(dirs**2, axis=0, keepdims=True)) + 1e-12
        pa = np.sort(a @ dirs, axis=0)
        pb = np.sort(b @ dirs, axis=0)
        total += float(np.mean(np.abs(pa - pb)))
    return total / n_repeats


def swd(
    real: np.ndarray,
    fake: np.ndarray,
    min_res: int = 16,
    patches_per_image: int = 64,
    patch: int = 7,
    n_dirs: int = 512,
    n_repeats: int = 4,
    seed: int = 0,
) -> dict[str, float]:
    """SWD between two image sets [N, C, H, W] in [-1, 1] (equal N).

    Returns {"swd_<res>": d*1e3 per pyramid level, "swd_avg": mean} — the
    x1e3 scaling follows the ProGAN paper's reporting convention.
    """
    if real.shape != fake.shape:
        raise ValueError(f"image sets differ in shape: {real.shape} vs {fake.shape}")
    size = real.shape[-1]
    n_levels = max(1, int(np.log2(max(size // min_res, 1))) + 1)
    pr = laplacian_pyramid(real, n_levels)
    pf = laplacian_pyramid(fake, n_levels)
    out: dict[str, float] = {}
    vals = []
    res = size
    for lr_, lf_ in zip(pr, pf):
        rng = np.random.RandomState(seed)  # same patches/projections per level
        a = extract_patches(lr_, patches_per_image, patch, rng)
        rng2 = np.random.RandomState(seed + 1)
        b = extract_patches(lf_, patches_per_image, patch, rng2)
        rngp = np.random.RandomState(seed + 2)
        d = sliced_wasserstein(a, b, n_dirs=n_dirs, n_repeats=n_repeats, rng=rngp)
        out[f"swd_{res}"] = d * 1e3
        vals.append(d * 1e3)
        res //= 2
    out["swd_avg"] = float(np.mean(vals))
    return out

"""FID / PRDC / PPL metric math (counterpart of maua_tpu/eval/metrics.py).

Sampling and feature extraction run on the device in batches; the O(N^2) and
eigen pieces (scipy `sqrtm`, k-NN radii, percentiles) run on the host in
float64, as in the JAX package. Random draws come from a `draws` object
(`maua_tpu_torch.draws.Draws`) handed to the samplers.
"""

from __future__ import annotations

import hashlib
import inspect
import os
import pickle
from typing import Any, Callable, Optional

import numpy as np
import scipy.linalg
import torch

from ..draws import Draws
from ..ops.resize import resize_bilinear

__all__ = [
    "cached_dataset_stats",
    "compute_stats",
    "fid",
    "fid_from_features",
    "frechet_distance",
    "ppl",
    "prdc",
    "vae_fid",
    "weights_fingerprint",
]


def _leaves(tree: Any, path: str = ""):
    """(keystr, array) of every leaf of nested mappings / sequences, with
    jax.tree_util.keystr's path syntax (`['a']['w']`, `[0]`)."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def weights_fingerprint(tree: Any) -> str:
    """Short stable hash of a state dict (or nested dict of arrays), so a
    metric's JSON records which backbone weights produced it. The same
    arrays under the same paths hash as the JAX package's fingerprint."""
    h = hashlib.sha256()
    for path, arr in sorted(_leaves(tree), key=lambda kv: kv[0]):
        h.update(path.encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:16]


def compute_stats(features) -> tuple[np.ndarray, np.ndarray]:
    """(mean, covariance) of a feature matrix [N, D], in float64."""
    features = np.asarray(features, np.float64)
    return features.mean(axis=0), np.cov(features, rowvar=False)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Frechet distance between two gaussians: scipy sqrtm, with an eps
    offset on the diagonals when it is not finite."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1.dot(sigma2))  # no `disp`: newer scipy removed it
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fid_from_features(fake_features, real_mu, real_sigma) -> float:
    return frechet_distance(*compute_stats(fake_features), real_mu, real_sigma)


def prdc(real_features, fake_features, nearest_k: int = 5) -> dict[str, float]:
    """Precision / recall / density / coverage from k-NN radii."""
    real = np.asarray(real_features, np.float64)
    fake = np.asarray(fake_features, np.float64)

    def pairwise(a, b):
        return np.sqrt(np.maximum((a**2).sum(1)[:, None] + (b**2).sum(1)[None, :] - 2 * a @ b.T, 0.0))

    def kth_radii(x, k):
        return np.sort(pairwise(x, x), axis=1)[:, k]  # k-th neighbour, self at column 0

    real_radii = kth_radii(real, nearest_k)
    fake_radii = kth_radii(fake, nearest_k)
    d_rf = pairwise(real, fake)
    return {
        "precision": float((d_rf < real_radii[:, None]).any(axis=0).mean()),
        "recall": float((d_rf < fake_radii[None, :]).any(axis=1).mean()),
        "density": float((1.0 / float(nearest_k)) * (d_rf < real_radii[:, None]).sum(axis=0).mean()),
        "coverage": float((d_rf.min(axis=1) < real_radii).mean()),
    }


def _host(x) -> np.ndarray:
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def fid(
    synthesize: Callable[..., torch.Tensor],
    feature_fn: Callable[[torch.Tensor], torch.Tensor],
    real_stats: tuple[np.ndarray, np.ndarray],
    n_sample: int = 2500,
    batch_size: int = 6,
    draws=None,
    real_features: Optional[np.ndarray] = None,
    compute_prdc: bool = False,
    truncation: Optional[float] = None,
) -> dict[str, float]:
    """Sample the generator and compute FID against cached real statistics.

    synthesize(draws, batch[, truncation]) -> images [-1, 1] NCHW;
    feature_fn(images) -> [N, D]. Each batch synthesizes with a truncation
    drawn U(0.9, 1.5) from `np.random.default_rng(0)` when `truncation` is
    None; a sampler that takes no third argument is called without one.
    `draws` defaults to `Draws(0)` on `cuda`."""
    draws = Draws(0) if draws is None else draws
    try:
        takes_trunc = len(inspect.signature(synthesize).parameters) >= 3
    except (TypeError, ValueError):
        takes_trunc = False
    trunc_rng = np.random.default_rng(0)
    feats = []
    with torch.no_grad():
        for _ in range(-(-n_sample // batch_size)):
            if takes_trunc:
                trunc = truncation if truncation is not None else float(trunc_rng.uniform(0.9, 1.5))
                imgs = synthesize(draws, batch_size, trunc)
            else:
                imgs = synthesize(draws, batch_size)
            feats.append(_host(feature_fn(imgs)))
    fake_features = np.concatenate(feats)[:n_sample]
    out = {"fid": fid_from_features(fake_features, *real_stats)}
    if compute_prdc and real_features is not None:
        out.update(prdc(real_features[: len(fake_features)], fake_features))
    return out


def cached_dataset_stats(
    feature_fn: Callable[[Any], torch.Tensor],
    data_iter,
    cache_path: str,
    max_items: Optional[int] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Dataset feature statistics, pickled to `cache_path` and read back from
    it when it exists. Only read a cache this program wrote."""
    if os.path.exists(cache_path):
        with open(cache_path, "rb") as f:
            return pickle.load(f)
    feats = []
    n = 0
    with torch.no_grad():
        for batch in data_iter:
            feats.append(_host(feature_fn(batch)))
            n += len(batch)
            if max_items is not None and n >= max_items:
                break
    stats = compute_stats(np.concatenate(feats))
    with open(cache_path, "wb") as f:
        pickle.dump(stats, f)
    return stats


def ppl(
    synthesize_from_w: Callable[[torch.Tensor], torch.Tensor],
    map_latents: Callable[[Any, int], torch.Tensor],
    distance_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    n_sample: int = 1250,
    batch_size: int = 8,
    eps: float = 1e-4,
    crop: bool = False,
    draws=None,
) -> float:
    """Perceptual path length in W: pairs lerped at t and t + eps, the
    perceptual distance over eps^2, images larger than 256^2 resized to 256^2
    first (bilinear, antialiased as JAX's resize), and the mean of the
    distances between the 1st (method "lower") and 99th ("higher")
    percentiles.

    map_latents(draws, n) -> W [n, D]; synthesize_from_w(w [N, D]) -> images;
    distance_fn(img0, img1) -> [N]. Per batch the draws are W for 2 x batch
    latents, then t ~ U[0, 1) [batch, 1]. `draws` defaults to `Draws(0)` on
    `cuda`."""
    draws = Draws(0) if draws is None else draws
    dists = []
    with torch.no_grad():
        for _ in range(-(-n_sample // batch_size)):
            w = map_latents(draws, batch_size * 2)
            t = draws.uniform(batch_size, 1).to(w)
            w0, w1 = w[::2], w[1::2]
            img = synthesize_from_w(torch.cat([w0 + (w1 - w0) * t, w0 + (w1 - w0) * (t + eps)]))
            if crop:
                c = img.shape[2] // 8
                img = img[:, :, c * 3 : c * 7, c * 2 : c * 6]
            if img.shape[2] // 256 > 1:
                img = resize_bilinear(img, (256, 256))
            dists.append(_host(distance_fn(img[:batch_size], img[batch_size:]) / (eps**2)))
    d = np.concatenate(dists)[:n_sample]
    lo = np.percentile(d, 1, method="lower")
    hi = np.percentile(d, 99, method="higher")
    return float(d[(d >= lo) & (d <= hi)].mean())


def vae_fid(
    reconstruct: Callable[[Any], torch.Tensor],
    feature_fn: Callable[[Any], torch.Tensor],
    data_iter,
    n_sample: int = 2500,
) -> float:
    """FID between a dataset's batches and `reconstruct` of them."""
    real_feats, fake_feats = [], []
    n = 0
    with torch.no_grad():
        for batch in data_iter:
            real_feats.append(_host(feature_fn(batch)))
            fake_feats.append(_host(feature_fn(reconstruct(batch))))
            n += len(batch)
            if n >= n_sample:
                break
    mu_r, s_r = compute_stats(np.concatenate(real_feats))
    return fid_from_features(np.concatenate(fake_feats), mu_r, s_r)

"""Beat tracking + laplacian structure segmentation (the port's own copy of
maua_tpu/audio/segmentation.py): Ellis dynamic-programming beat tracking,
beat-synchronous CQT recurrence matrix, path-similarity balancing, normalized
graph laplacian, spectral clustering into k sections. The features (pseudo-CQT,
MFCC, onset strength) are computed on the input's device; the combinatorial
stages run on the host in numpy/scipy, with the port's own k-means."""

from __future__ import annotations

import numpy as np
import scipy.linalg
import scipy.ndimage
import scipy.sparse.csgraph

from .chroma import pseudo_cqt
from .dsp import amplitude_to_db
from .features import mfcc
from .onsets import onset_strength
from .postprocess import as_tensor, to_numpy

__all__ = ["beat_track", "laplacian_segmentation"]


def _tempo_estimate(onset_env: np.ndarray, sr: int, hop_length: int, start_bpm: float = 120.0) -> float:
    """Tempo from the onset autocorrelation with a log-normal prior centred on
    start_bpm (the tempogram method librosa uses)."""
    n = len(onset_env)
    if n < 4:
        return start_bpm
    env = onset_env - onset_env.mean()
    ac = np.maximum(np.correlate(env, env, mode="full")[n - 1 :], 0)
    fps = sr / hop_length
    lags = np.arange(1, min(n, int(fps * 4)))  # up to 4s period
    bpms = 60.0 * fps / lags
    prior = np.exp(-0.5 * ((np.log2(bpms) - np.log2(start_bpm)) / 1.0) ** 2)
    best = lags[int(np.argmax(ac[lags] * prior))]
    return float(60.0 * fps / best)


def beat_track(
    y=None,
    sr: int = 22050,
    onset_env=None,
    hop_length: int = 512,
    start_bpm: float = 120.0,
    tightness: float = 100.0,
    trim: bool = False,
) -> tuple[float, np.ndarray]:
    """Ellis dynamic-programming beat tracker: (tempo_bpm, beat frame
    indices), librosa.beat.beat_track equivalent."""
    if onset_env is None:
        onset_env = onset_strength(as_tensor(y), sr=sr, hop_length=hop_length)
    env = to_numpy(onset_env).astype(np.float64)
    if env.size == 0 or env.max() <= 0:
        return start_bpm, np.array([], dtype=int)
    env = env / env.std() if env.std() > 0 else env

    tempo = _tempo_estimate(env, sr, hop_length, start_bpm)
    fps = sr / hop_length
    period = max(1, int(round(60.0 * fps / tempo)))

    # DP: score[t] = env[t] + max_{lag} (score[t-lag] - tightness*(log(lag/period))^2)
    n = len(env)
    backlink = np.full(n, -1, dtype=int)
    cumscore = env.copy()
    lags = np.arange(max(1, period // 2), min(n, 2 * period))
    penalty = -tightness * (np.log(lags / period)) ** 2
    for t in range(int(lags[0]), n):
        lo = t - int(lags[-1])
        hi = t - int(lags[0])
        if hi < 0:
            continue
        window = cumscore[max(lo, 0) : hi + 1]
        pen = penalty[len(penalty) - len(window) :][::-1] if len(window) < len(penalty) else penalty[::-1]
        pen = pen[-len(window) :]
        scores = window + pen
        best = int(np.argmax(scores))
        cumscore[t] = env[t] + scores[best]
        backlink[t] = max(lo, 0) + best

    beats = [int(np.argmax(cumscore[-period:]) + n - period)]
    while backlink[beats[-1]] >= 0:
        beats.append(int(backlink[beats[-1]]))
    beats = np.array(beats[::-1], dtype=int)

    if trim and len(beats) > 2:
        beats = beats[1:-1]
    return tempo, beats


def _sync(X: np.ndarray, beats: np.ndarray, aggregate=np.mean) -> np.ndarray:
    """Aggregate feature columns between beat boundaries (librosa.util.sync)."""
    T = X.shape[1]
    bounds = np.unique(np.clip(np.concatenate([[0], beats, [T]]), 0, T))
    cols = []
    for s, e in zip(bounds[:-1], bounds[1:]):
        seg = X[:, s:e] if e > s else X[:, s : s + 1]
        cols.append(aggregate(seg, axis=1))
    return np.stack(cols, axis=1)


def _recurrence_affinity(X: np.ndarray, width: int = 3, k: int | None = None) -> np.ndarray:
    """Symmetric affinity recurrence matrix over feature columns
    (librosa.segment.recurrence_matrix(mode='affinity', sym=True))."""
    T = X.shape[1]
    if k is None:
        k = min(T - 1, max(1, int(np.ceil(np.sqrt(T)))))
    D = np.linalg.norm(X[:, :, None] - X[:, None, :], axis=0)  # [T, T]
    band = np.abs(np.arange(T)[:, None] - np.arange(T)[None, :]) < width
    Dm = D.copy()
    Dm[band] = np.inf
    nn = np.argpartition(Dm, min(k, T - 1), axis=1)[:, :k]
    mask = np.zeros((T, T), dtype=bool)
    mask[np.repeat(np.arange(T), k), nn.reshape(-1)] = True
    mask &= ~band
    mask = mask | mask.T
    sigma = np.median(D[mask]) if mask.any() else 1.0
    A = np.exp(-(D**2) / (2 * max(sigma, 1e-6) ** 2))
    return A * mask


def _kmeans(X: np.ndarray, k: int, n_init: int = 10, iters: int = 300, seed: int = 0) -> np.ndarray:
    """Lloyd's k-means with k-means++ seeding, best of n_init runs by
    inertia; returns the labels."""
    rng = np.random.default_rng(seed)
    best_labels, best_inertia = None, np.inf
    for _ in range(n_init):
        centers = [X[rng.integers(len(X))]]
        for _ in range(1, k):
            d2 = np.min(((X[:, None, :] - np.asarray(centers)[None]) ** 2).sum(-1), axis=1)
            p = d2 / d2.sum() if d2.sum() > 0 else np.full(len(X), 1.0 / len(X))
            centers.append(X[rng.choice(len(X), p=p)])
        centers = np.asarray(centers)
        labels = np.full(len(X), -1)
        for _ in range(iters):
            d2 = ((X[:, None, :] - centers[None]) ** 2).sum(-1)
            new = np.argmin(d2, axis=1)
            if np.array_equal(new, labels):
                break
            labels = new
            centers = np.stack([X[labels == j].mean(0) if np.any(labels == j) else centers[j] for j in range(k)])
        inertia = ((X - centers[labels]) ** 2).sum()
        if inertia < best_inertia:
            best_labels, best_inertia = labels, inertia
    return best_labels


def laplacian_segmentation(signal, sr: int, k: int = 5, plot: bool = False):
    """Structure segmentation: (boundary_times_sec, segment_labels)."""
    y = as_tensor(signal)
    hop = 512
    BPO = 12 * 3
    C = to_numpy(amplitude_to_db(pseudo_cqt(y, sr=sr, n_bins=7 * BPO, bins_per_octave=BPO, hop_length=hop), ref=1.0))
    C = C - C.max()

    tempo, beats = beat_track(y=y, sr=sr, hop_length=hop)
    if len(beats) < max(8, k + 2):
        return [0.0], [0]  # too few beats to segment: one segment

    Csync = _sync(C, beats, aggregate=np.median)

    R = _recurrence_affinity(Csync, width=3)
    # diagonal (time-lag) median filter to enhance repeated sections
    T = R.shape[0]
    Rf = np.zeros_like(R)
    for d in range(-T + 1, T):
        sm = scipy.ndimage.median_filter(np.diagonal(R, d), size=7, mode="nearest")
        idx = np.arange(len(sm))
        if d >= 0:
            Rf[idx, idx + d] = sm
        else:
            Rf[idx - d, idx] = sm

    Msync = _sync(to_numpy(mfcc(y, sr=sr, hop_length=hop)), beats)
    path_distance = np.sum(np.diff(Msync, axis=1) ** 2, axis=0)
    sigma = np.median(path_distance) if len(path_distance) else 1.0
    path_sim = np.exp(-path_distance / max(sigma, 1e-9))
    R_path = np.diag(path_sim, k=1) + np.diag(path_sim, k=-1)

    deg_path = R_path.sum(axis=1)
    deg_rec = Rf.sum(axis=1)
    denom = np.sum((deg_path + deg_rec) ** 2)
    mu = deg_path.dot(deg_path + deg_rec) / denom if denom > 0 else 0.5

    A = mu * Rf + (1 - mu) * R_path
    L = scipy.sparse.csgraph.laplacian(A, normed=True)
    evals, evecs = scipy.linalg.eigh(L)
    evecs = scipy.ndimage.median_filter(evecs, size=(9, 1))
    Cnorm = np.cumsum(evecs**2, axis=1) ** 0.5
    X = evecs[:, :k] / np.maximum(Cnorm[:, k - 1 : k], 1e-9)

    seg_ids = _kmeans(X, k)

    bound_beats = 1 + np.flatnonzero(seg_ids[:-1] != seg_ids[1:])
    bound_beats = np.unique(np.concatenate([[0], bound_beats]))
    bound_segs = list(seg_ids[bound_beats])
    # beat index -> frame index; column c of Csync covers beats[c-1]:beats[c]
    frames = np.concatenate([[0], beats])
    bound_frames = frames[np.clip(bound_beats, 0, len(frames) - 1)]
    bound_times = (bound_frames * hop / sr).astype(float)
    if len(bound_times) == 0 or bound_times[0] != 0:
        bound_times = np.concatenate([[0.0], bound_times])
        bound_segs = [bound_segs[0] if bound_segs else 0] + list(bound_segs)
    return list(bound_times), [int(s) for s in bound_segs]

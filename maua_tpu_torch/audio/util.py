"""Plot / debug utilities (counterpart of maua_tpu/audio/util.py).
matplotlib is imported only inside the plot functions."""

from __future__ import annotations

import torch

from .postprocess import to_numpy

__all__ = ["info", "plot_signals", "plot_spectra", "plot_audio", "plot_chroma_comparison"]


def info(arr, label: str = "") -> str:
    """Tensor statistics one-liner."""
    a = to_numpy(arr)
    msg = (
        f"{label + ' ' if label else ''}shape={tuple(a.shape)} "
        f"min={a.min():.4f} mean={a.mean():.4f} max={a.max():.4f} std={a.std():.4f}"
    )
    print(msg)
    return msg


def _pyplot(out_file):
    import matplotlib

    if out_file:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save_or_show(plt, fig, out_file):
    if out_file:
        fig.savefig(out_file, bbox_inches="tight", dpi=120)
        plt.close(fig)
        return out_file
    plt.show()
    return None


def plot_signals(signals, labels=None, out_file: str | None = None):
    """Stacked envelope plots."""
    plt = _pyplot(out_file)
    signals = [to_numpy(s) for s in signals]
    fig, axes = plt.subplots(len(signals), 1, figsize=(12, 2 * len(signals)), squeeze=False)
    for i, sig in enumerate(signals):
        axes[i, 0].plot(sig.squeeze())
        if labels:
            axes[i, 0].set_ylabel(labels[i])
    return _save_or_show(plt, fig, out_file)


def plot_spectra(spectra, chroma: bool = False, labels=None, out_file: str | None = None):
    """Stacked spectrogram images."""
    plt = _pyplot(out_file)
    spectra = [to_numpy(s) for s in spectra]
    fig, axes = plt.subplots(len(spectra), 1, figsize=(12, 3 * len(spectra)), squeeze=False)
    for i, spec in enumerate(spectra):
        axes[i, 0].imshow(spec, aspect="auto", origin="lower", cmap="magma")
        if labels:
            axes[i, 0].set_ylabel(labels[i])
    return _save_or_show(plt, fig, out_file)


def plot_audio(audio, sr: int, n_fft: int = 2048, hop_length: int = 512, out_file: str | None = None):
    """Log-magnitude spectrogram of a waveform."""
    plt = _pyplot(out_file)
    from .dsp import amplitude_to_db, stft

    S = to_numpy(amplitude_to_db(torch.abs(stft(audio, n_fft, hop_length))))
    fig, ax = plt.subplots(figsize=(12, 4))
    im = ax.imshow(S, aspect="auto", origin="lower", cmap="magma", extent=[0, len(to_numpy(audio)) / sr, 0, sr / 2])
    ax.set_xlabel("time [s]")
    ax.set_ylabel("freq [Hz]")
    fig.colorbar(im, ax=ax)
    return _save_or_show(plt, fig, out_file)


def plot_chroma_comparison(audio, sr: int, out_file: str | None = None):
    """All chroma variants side by side."""
    plt = _pyplot(out_file)
    from .chroma import raw_chroma

    types = ["cens", "cqt", "stft"]
    fig, axes = plt.subplots(len(types), 1, figsize=(12, 3 * len(types)), squeeze=False)
    for i, t in enumerate(types):
        axes[i, 0].imshow(to_numpy(raw_chroma(audio, sr, type=t, nearest_neighbor=False)), aspect="auto", origin="lower", cmap="magma")
        axes[i, 0].set_ylabel(t)
    return _save_or_show(plt, fig, out_file)

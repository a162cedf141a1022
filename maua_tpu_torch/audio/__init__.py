"""Audio feature extraction in PyTorch (counterpart of maua_tpu/audio).

STFT, mel / log / chroma filterbanks, HPSS, onset ensembles, RMS envelopes
and envelope post-processing compute on the device of their tensor inputs
(numpy inputs go to the package's default device: `set_device`, `cuda` unless
set). Beat DP, clustering, band-pass filtering and WAV decoding run on the
host in numpy/scipy. The names are the JAX package's, so a plugin file ports
line for line (with torch in place of jnp).
"""

from .postprocess import (
    SMF,
    set_SMF,
    get_SMF,
    set_device,
    get_device,
    as_tensor,
    normalize,
    percentile,
    percentile_clip,
    compress,
    expand,
    gaussian_filter,
)
from .io import load_audio
from .dsp import stft, istft, mel_filterbank, melspectrogram, amplitude_to_db, power_to_db, resample_signal
from .hpss import hpss, harmonic, percussive
from .onsets import onsets, onset_strength, madmom_onset_ensemble
from .features import rms, mfcc, drop_strength
from .chroma import chroma, raw_chroma, chroma_stft, chroma_cqt, chroma_cens, chroma_clp, pseudo_cqt
from .segmentation import beat_track, laplacian_segmentation
from .util import info, plot_signals, plot_spectra, plot_audio, plot_chroma_comparison

__all__ = [
    "SMF",
    "set_SMF",
    "get_SMF",
    "set_device",
    "get_device",
    "as_tensor",
    "normalize",
    "percentile",
    "percentile_clip",
    "compress",
    "expand",
    "gaussian_filter",
    "load_audio",
    "stft",
    "istft",
    "mel_filterbank",
    "melspectrogram",
    "amplitude_to_db",
    "power_to_db",
    "resample_signal",
    "hpss",
    "harmonic",
    "percussive",
    "onsets",
    "onset_strength",
    "madmom_onset_ensemble",
    "rms",
    "mfcc",
    "drop_strength",
    "chroma",
    "raw_chroma",
    "chroma_stft",
    "chroma_cqt",
    "chroma_cens",
    "chroma_clp",
    "pseudo_cqt",
    "beat_track",
    "laplacian_segmentation",
    "info",
    "plot_signals",
    "plot_spectra",
    "plot_audio",
    "plot_chroma_comparison",
]

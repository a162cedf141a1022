"""Audio loading with workspace caching (the port's own copy of
maua_tpu/audio/io.py): WAV via scipy, other formats via an ffmpeg binary when
one is on PATH, resampled to 22050 Hz, cached as
`<cache_dir>/<stem>[_lengthX][_startY].npz` relative to the working directory.
Returns host numpy; `generate()` moves it to its device."""

from __future__ import annotations

import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import scipy.io.wavfile
import scipy.signal

DEFAULT_SR = 22050  # librosa's default target sample rate


def _decode_wav(path: str) -> tuple[np.ndarray, int]:
    sr, data = scipy.io.wavfile.read(path)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:
        audio = data.astype(np.float32)
    if audio.ndim == 2:
        audio = audio.mean(axis=1)
    return audio, sr


def _decode_ffmpeg(path: str, sr: int) -> tuple[np.ndarray, int]:
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(f"cannot decode {path!r}: not a WAV file and no ffmpeg binary available")
    proc = subprocess.run(
        [ffmpeg, "-v", "error", "-i", path, "-f", "f32le", "-ac", "1", "-ar", str(sr), "-"],
        capture_output=True,
        check=True,
    )
    return np.frombuffer(proc.stdout, dtype=np.float32).copy(), sr


def load_audio(
    audio_file: str,
    offset: float = 0.0,
    duration: float = -1.0,
    cache: bool = True,
    target_sr: int = DEFAULT_SR,
    cache_dir: str = "workspace",
):
    """(audio, sr, duration): mono float32 numpy at target_sr, cached."""
    p = Path(audio_file)
    cache_file = Path(cache_dir) / (
        p.stem
        + ("" if duration == -1 else f"_length{duration}")
        + ("" if offset == 0 else f"_start{offset}")
        + ".npz"
    )
    if cache and cache_file.exists():
        z = np.load(cache_file)
        audio, sr = z["audio"], int(z["sr"])
        return audio, sr, len(audio) / sr

    if p.suffix.lower() == ".wav":
        audio, sr = _decode_wav(str(p))
    else:
        audio, sr = _decode_ffmpeg(str(p), target_sr)

    if sr != target_sr:
        n_out = int(round(len(audio) * target_sr / sr))
        audio = scipy.signal.resample(audio, n_out).astype(np.float32)
        sr = target_sr

    if offset:
        audio = audio[int(offset * sr) :]
    if duration != -1:
        audio = audio[: int(duration * sr)]
    audio = np.ascontiguousarray(audio, dtype=np.float32)

    if cache:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(cache_file, audio=audio, sr=sr)

    return audio, sr, len(audio) / sr

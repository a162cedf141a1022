"""Video sinks (counterpart of maua_tpu/render/video.py:20-106).

`VideoWriter` takes HWC uint8 RGB frames and encodes them with an ffmpeg pipe
(libx264, optional audio mux) when ffmpeg is on PATH, else with OpenCV (mp4v),
else buffers them and saves `<output_file>.npy` on close.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

import numpy as np


class VideoWriter:
    """Streaming frame sink: write() HWC uint8 frames, then close()."""

    def __init__(
        self,
        output_file: str,
        width: int,
        height: int,
        fps: float,
        audio_file: Optional[str] = None,
        offset: float = 0.0,
        duration: Optional[float] = None,
        ffmpeg_preset: str = "slow",
    ):
        self.output_file = output_file
        self.width = width
        self.height = height
        self.fps = fps
        self.n_written = 0
        self._proc = None
        self._cv = None
        self._frames: list[np.ndarray] = []

        os.makedirs(os.path.dirname(os.path.abspath(output_file)) or ".", exist_ok=True)
        ffmpeg = shutil.which("ffmpeg")
        if ffmpeg is not None:
            cmd = [ffmpeg, "-hide_banner", "-v", "warning", "-y",
                   "-f", "rawvideo", "-pix_fmt", "rgb24", "-s", f"{width}x{height}",
                   "-framerate", str(fps), "-i", "pipe:"]
            if audio_file is not None:
                cmd += ["-ss", str(offset)]
                if duration is not None:
                    cmd += ["-t", str(duration)]
                cmd += ["-i", audio_file, "-map", "0:v", "-map", "1:a", "-audio_bitrate", "320K", "-ac", "2"]
            cmd += ["-vcodec", "libx264", "-pix_fmt", "yuv420p", "-preset", ffmpeg_preset, output_file]
            self._proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)
            self.backend = "ffmpeg"
            return
        try:
            import cv2
        except ImportError:
            cv2 = None
        if cv2 is not None:
            cv = cv2.VideoWriter(output_file, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height))
            if cv.isOpened():
                self._cv, self._cv2 = cv, cv2
                self.backend = "opencv"
                return
        self.backend = "npy"

    def write(self, frame: np.ndarray) -> None:
        """frame: [H, W, 3] uint8 RGB."""
        if frame.shape != (self.height, self.width, 3):
            raise ValueError(f"frame shape {frame.shape} != {(self.height, self.width, 3)}")
        if self._proc is not None:
            self._proc.stdin.write(np.ascontiguousarray(frame).tobytes())
        elif self._cv is not None:
            self._cv.write(self._cv2.cvtColor(frame, self._cv2.COLOR_RGB2BGR))
        else:
            self._frames.append(frame.copy())
        self.n_written += 1

    def close(self) -> None:
        if self._proc is not None:
            self._proc.stdin.close()
            if self._proc.wait() != 0:
                raise RuntimeError(f"ffmpeg exited with code {self._proc.returncode} writing {self.output_file}")
        elif self._cv is not None:
            self._cv.release()
        else:
            path = self.output_file if self.output_file.endswith(".npy") else self.output_file + ".npy"
            frames = np.stack(self._frames) if self._frames else np.zeros((0, self.height, self.width, 3), np.uint8)
            np.save(path, frames)


def write_video(arr: np.ndarray, output_file: str, fps: float) -> None:
    """Write a [T, H, W, 3] uint8 array in one call."""
    arr = np.asarray(arr)
    vw = VideoWriter(output_file, arr.shape[2], arr.shape[1], fps)
    for frame in arr:
        vw.write(frame.astype(np.uint8))
    vw.close()

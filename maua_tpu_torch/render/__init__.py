"""Streaming renderer: batched synthesis -> uint8 packing on the device ->
double-buffered device-to-host copy -> writer thread -> video encode."""

from .frames import render
from .video import VideoWriter, write_video

__all__ = ["VideoWriter", "render", "write_video"]

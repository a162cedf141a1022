"""The audio-reactive generation API + plugin protocol."""

from .generate import generate, get_noise_range, load_generator_for_render
from . import defaults

__all__ = ["generate", "get_noise_range", "load_generator_for_render", "defaults"]

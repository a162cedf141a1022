"""StyleGAN2 generator and its blocks."""

from .blocks import (
    ConstantInput,
    EqualLinear,
    FusedLeakyReLU,
    LatentInput,
    ModulatedConv2d,
    NoiseInjection,
    StyledConv,
    ToRGB,
    apply_bends,
    pixel_norm,
)
from .stylegan2 import Generator, MappingNetwork, channel_map, noise_shapes

__all__ = [
    "ConstantInput",
    "EqualLinear",
    "FusedLeakyReLU",
    "Generator",
    "LatentInput",
    "MappingNetwork",
    "ModulatedConv2d",
    "NoiseInjection",
    "StyledConv",
    "ToRGB",
    "apply_bends",
    "channel_map",
    "noise_shapes",
    "pixel_norm",
]

"""StyleGAN2 generator, discriminator and their blocks."""

from .blocks import (
    ConstantInput,
    ConvLayer,
    Downsample,
    EqualConv2d,
    EqualLinear,
    FusedLeakyReLU,
    LatentInput,
    ModulatedConv2d,
    NoiseInjection,
    ResBlock,
    StyledConv,
    ToRGB,
    apply_bends,
    minibatch_stddev,
    pixel_norm,
)
from .stylegan2 import Discriminator, Generator, MappingNetwork, channel_map, noise_shapes

__all__ = [
    "ConstantInput",
    "ConvLayer",
    "Discriminator",
    "Downsample",
    "EqualConv2d",
    "EqualLinear",
    "FusedLeakyReLU",
    "Generator",
    "LatentInput",
    "MappingNetwork",
    "ModulatedConv2d",
    "NoiseInjection",
    "ResBlock",
    "StyledConv",
    "ToRGB",
    "apply_bends",
    "channel_map",
    "minibatch_stddev",
    "noise_shapes",
    "pixel_norm",
]

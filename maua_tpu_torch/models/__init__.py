"""StyleGAN2 generator, discriminator and their blocks; the StyleGAN1 generator."""

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
from .stylegan1 import StyleGAN1, load_stylegan1
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
    "StyleGAN1",
    "StyledConv",
    "ToRGB",
    "apply_bends",
    "channel_map",
    "load_stylegan1",
    "minibatch_stddev",
    "noise_shapes",
    "pixel_norm",
]

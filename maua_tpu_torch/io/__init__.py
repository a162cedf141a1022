"""Checkpoint ingestion and weights carried across from the JAX package."""

from .jax_params import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
    projection_head_state_dict_from_jax,
)
from .torch_ckpt import infer_generator_config, load_generator, load_torch_checkpoint

__all__ = [
    "discriminator_state_dict_from_jax",
    "generator_state_dict_from_jax",
    "infer_generator_config",
    "load_generator",
    "load_torch_checkpoint",
    "projection_head_state_dict_from_jax",
]

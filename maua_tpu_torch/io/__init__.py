"""Checkpoint ingestion (rosinality .pt, TF .pkl) and weights carried
across from the JAX package."""

from .jax_params import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
    inception_state_dict_from_jax,
    lpips_state_dict_from_jax,
    lucidrains_state_dict_from_jax,
    projection_head_state_dict_from_jax,
    stylegan1_state_dict_from_jax,
    vae_state_dict_from_jax,
)
from .tf_pkl import generator_state_dict_from_tf, load_tf_generator, load_tf_pickle_networks
from .torch_ckpt import infer_generator_config, load_generator, load_torch_checkpoint

__all__ = [
    "discriminator_state_dict_from_jax",
    "generator_state_dict_from_jax",
    "generator_state_dict_from_tf",
    "inception_state_dict_from_jax",
    "infer_generator_config",
    "load_generator",
    "load_tf_generator",
    "load_tf_pickle_networks",
    "load_torch_checkpoint",
    "lpips_state_dict_from_jax",
    "lucidrains_state_dict_from_jax",
    "projection_head_state_dict_from_jax",
    "stylegan1_state_dict_from_jax",
    "vae_state_dict_from_jax",
]

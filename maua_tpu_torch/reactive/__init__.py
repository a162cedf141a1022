"""Audio-reactive latent / noise / bend / rewrite toolkit (counterpart of
maua_tpu/reactive): latent interpolation (slerp / spline loops), chroma
-weighted latent mixes, tileable 3-D perlin noise, network bends as functions
over activations with per-frame modulation, and per-batch weight rewrites."""

from .latent import (
    chroma_weight_latents,
    slerp,
    slerp_loops,
    spline_loops,
    wrapping_slice,
    generate_latents,
    save_latents,
    load_latents,
)
from .noise import perlin_noise, looping_perlin, reactive_noise
from .bend import (
    Bend,
    add_noise_bend,
    translate_bend,
    zoom_bend,
    rotate_bend,
    pad_bend,
    print_bend,
    bends_for_batch,
)
from .rewrite import Rewrite, apply_rewrites, rewrites_for_batch

__all__ = [
    "chroma_weight_latents",
    "slerp",
    "slerp_loops",
    "spline_loops",
    "wrapping_slice",
    "generate_latents",
    "save_latents",
    "load_latents",
    "perlin_noise",
    "looping_perlin",
    "reactive_noise",
    "Bend",
    "add_noise_bend",
    "translate_bend",
    "zoom_bend",
    "rotate_bend",
    "pad_bend",
    "print_bend",
    "bends_for_batch",
    "Rewrite",
    "apply_rewrites",
    "rewrites_for_batch",
]

"""Spectral-norm tracking by power iteration, tracking only (counterpart of
maua_tpu/telemetry/spectral.py; the reference's validation/spectral_norm.py).

`init_spectral_state(module)` gives every weight of 2 or more dimensions a
unit u-vector; `spectral_norms(module, state)` runs one power-iteration step
per weight and returns ({name: sigma}, new state). Names and matrices are the
JAX package's, so both packages track the same quantities: a weight is keyed
by its flax path ("convs_0/conv/weight", "block_4/conv1/conv/weight") and
viewed as the flax array reshaped to [shape[0], -1]: a linear weight
transposed to flax's [in, out], a modulated conv's [1, O, I, k, k] as
[O, I, k, k]. Translating the names knows the StyleGAN2 `Generator` and
`Discriminator`; any other module keeps its state-dict keys."""

from __future__ import annotations

import re
from typing import Optional

import torch
from torch import nn

_G_RULES = [
    (r"^style\.(\d+)\.", lambda m: f"style/dense_{int(m.group(1)) - 1}/"),
    (r"^input\.", lambda m: "g_input/"),
    (r"^convs\.(\d+)\.", lambda m: f"convs_{m.group(1)}/"),
    (r"^to_rgbs\.(\d+)\.", lambda m: f"to_rgbs_{m.group(1)}/"),
]


def _jax_name(module: nn.Module, key: str) -> str:
    from ..models import Discriminator, Generator

    if isinstance(module, Generator):
        for pattern, repl in _G_RULES:
            key = re.sub(pattern, repl, key)
        return key.replace(".", "/")
    if isinstance(module, Discriminator):
        log_size = module.size.bit_length() - 1
        parts = key.split(".")
        if parts[:2] == ["convs", "0"]:
            return "from_rgb/conv/weight"
        if parts[0] == "convs":  # convs.<j>.<conv1|conv2|skip>.<i>.weight
            return f"block_{log_size - int(parts[1]) + 1}/{parts[2]}/conv/weight"
        if parts[0] == "final_conv":
            return "final_conv/conv/weight"
        return f"final_linear_{parts[1]}/weight"
    return key


def _as_matrix(w: torch.Tensor) -> torch.Tensor:
    """The flax array's [shape[0], -1] matrix."""
    if w.ndim == 2:  # flax Dense kernels are [in, out]
        w = w.t()
    elif w.ndim == 5:  # a modulated conv's [1, O, I, k, k]
        w = w[0]
    return w.reshape(w.shape[0], -1)


def _iter_weights(module: nn.Module):
    """(flax name, matrix) of every parameter with 2 or more dimensions, in
    the order of the flax names."""
    named = [(_jax_name(module, k), p) for k, p in module.named_parameters() if p.ndim >= 2]
    for name, p in sorted(named, key=lambda t: t[0]):
        yield name, _as_matrix(p.detach().float())


def init_spectral_state(module: nn.Module, generator: Optional[torch.Generator] = None) -> dict[str, torch.Tensor]:
    """A random unit u-vector per tracked weight, from `generator` (default:
    a CPU generator seeded with 0), on the weights' device."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    state = {}
    for name, m in _iter_weights(module):
        u = torch.randn(m.shape[0], generator=generator, device=generator.device).to(m.device)
        state[name] = u / torch.linalg.vector_norm(u)
    return state


@torch.no_grad()
def spectral_norms(module: nn.Module, state: dict[str, torch.Tensor], n_iter: int = 1, eps: float = 1e-12):
    """n_iter power-iteration steps per weight -> ({name: sigma}, new state)."""
    sigmas: dict[str, torch.Tensor] = {}
    new_state: dict[str, torch.Tensor] = {}
    for name, m in _iter_weights(module):
        u = state[name]
        for _ in range(n_iter):
            v = m.t() @ u
            v = v / torch.clamp(torch.linalg.vector_norm(v), min=eps)
            u = m @ v
            u = u / torch.clamp(torch.linalg.vector_norm(u), min=eps)
        sigmas[name] = u @ (m @ v)
        new_state[name] = u
    return sigmas, new_state


def summarize(sigmas: dict[str, torch.Tensor]) -> dict[str, float]:
    """min / mean / max of the sigmas, as the reference logs them."""
    vals = torch.stack(list(sigmas.values()))
    return {"spectral_min": float(vals.min()), "spectral_mean": float(vals.mean()), "spectral_max": float(vals.max())}

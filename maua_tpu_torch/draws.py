"""Random variates for the inference and evaluation tools, kept apart from
their arithmetic.

A tool that needs random numbers takes a `draws` object and calls its
`normal(*shape)` / `uniform(*shape)` in a fixed order. `Draws` serves them
from one `torch.Generator` on a device; a caller may pass any object with the
same two methods instead, e.g. one that replays precomputed arrays (the tests
replay the JAX package's draws this way).
"""

from __future__ import annotations

import torch

from .device import DeviceLike, resolve_device

__all__ = ["Draws"]


class Draws:
    """N(0, 1) and U[0, 1) tensors from one `torch.Generator` seeded with
    `seed` on `device` (default `cuda`; RuntimeError without a card)."""

    def __init__(self, seed: int, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))

    def normal(self, *shape: int) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device)

    def uniform(self, *shape: int) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.device)

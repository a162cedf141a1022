"""Network bending record (counterpart of maua_tpu/reactive/bend.py:28-33).

A `Bend(layer, transform, modulation)` applies `transform(x, mod)` to the
activation [B, C, H, W] of generator layer `layer`, with the batch's slice
`mod` [B] of the modulation timeline (or None). The bend transforms
(translate, zoom, rotate, noise, pad) come with the reactive slice.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class Bend(NamedTuple):
    layer: int
    transform: Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]  # (x, mod[B]) -> x
    modulation: Optional[object] = None  # [n_frames] timeline (None = static)

"""Generator EMA (counterpart of maua_tpu/train/ema.py): decay 0.5^(32/10k).

`ema_update` updates the EMA tensors IN PLACE (the JAX function returns new
arrays): ema <- ema * decay + params * (1 - decay).
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["EMA_DECAY_DEFAULT", "ema_update"]

EMA_DECAY_DEFAULT = 0.5 ** (32 / 10_000)  # ~ 0.99778


@torch.no_grad()
def ema_update(
    ema_params: Sequence[torch.Tensor], params: Sequence[torch.Tensor], decay: float = EMA_DECAY_DEFAULT
) -> None:
    """ema <- decay * ema + (1 - decay) * params, in place, tensor by tensor."""
    ema_params, params = list(ema_params), list(params)
    if len(ema_params) != len(params):
        raise ValueError(f"ema_update: {len(ema_params)} EMA tensors for {len(params)} parameters")
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, torch._foreach_mul(params, 1.0 - decay))

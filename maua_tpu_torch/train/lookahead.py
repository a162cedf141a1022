"""Lookahead-minimax (counterpart of maua_tpu/train/lookahead.py).

Every `k` G steps both networks' fast weights are pulled toward cached slow
weights with coefficient `alpha`, and the cache is refreshed (the joint
minimax lookahead of Chavdarova et al.). `lookahead_minimax_step` updates the
parameters and the cache IN PLACE (`lerp_`); the JAX function returns new
pytrees.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

__all__ = ["LookaheadState", "lookahead_minimax_init", "lookahead_minimax_step"]


@dataclass
class LookaheadState:
    slow_g: list[torch.Tensor]  # cached slow G parameters
    slow_d: list[torch.Tensor]  # cached slow D parameters
    step: int = 0  # G-step counter


@torch.no_grad()
def lookahead_minimax_init(g_params: Sequence[torch.Tensor], d_params: Sequence[torch.Tensor]) -> LookaheadState:
    return LookaheadState([p.detach().clone() for p in g_params], [p.detach().clone() for p in d_params], 0)


@torch.no_grad()
def lookahead_minimax_step(
    state: LookaheadState,
    g_params: Sequence[torch.Tensor],
    d_params: Sequence[torch.Tensor],
    k: int = 500,
    alpha: float = 0.5,
) -> bool:
    """Advance the clock; on every k-th step set slow <- slow + alpha * (fast
    - slow) and fast <- slow, for G and D. Returns whether it synced."""
    state.step += 1
    if state.step % k != 0:
        return False
    for slow, fast in ((state.slow_g, list(g_params)), (state.slow_d, list(d_params))):
        torch._foreach_lerp_(slow, fast, alpha)
        torch._foreach_copy_(fast, slow)
    return True

"""Model rewriting: per-batch weight overrides (counterpart of
maua_tpu/reactive/rewrite.py:21-66).

A `Rewrite(param_path, transform, modulation)` names a parameter or buffer by
its dotted state-dict key (e.g. "convs.3.conv.weight", whose tensor has the
rosinality layout [1, O, I, k, k]). `transform(weight, mod)` is applied to the
ORIGINAL tensor with the batch's modulation slice `mod` [B] (or None), and
`apply_rewrites` returns the overrides, which `render()` feeds to
`torch.func.functional_call`; the module's own weights are never changed.
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple, Optional, Sequence

import torch


class Rewrite(NamedTuple):
    param_path: str  # dotted state-dict key, e.g. "convs.3.conv.weight"
    transform: Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]  # (weight, mod[B]) -> weight
    modulation: Optional[object] = None  # [n_frames] timeline


def apply_rewrites(
    params: Mapping[str, torch.Tensor],
    rewrites: Sequence[Rewrite],
    mods: Sequence[Optional[torch.Tensor]],
) -> dict[str, torch.Tensor]:
    """{param_path: transform(params[param_path], mod)} for each rewrite."""
    out: dict[str, torch.Tensor] = {}
    for rw, mod in zip(rewrites, mods):
        if rw.param_path not in params:
            raise KeyError(f"rewrite path {rw.param_path!r} is not a parameter or buffer of the generator")
        out[rw.param_path] = rw.transform(params[rw.param_path], mod)
    return out

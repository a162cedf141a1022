"""Device selection for the port's entry points.

The port runs on a CUDA card. An entry point given no device takes `cuda` and
fails loudly when there is none; the CPU is used only when the caller names it
(`device="cpu"`), as the tests do.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` -> `cuda`; raise `RuntimeError` if a CUDA device is asked for
    (explicitly or by default) and `torch.cuda.is_available()` is False."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "maua_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev

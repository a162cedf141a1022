"""Rosinality StyleGAN2 `.pt` checkpoints -> the port's Generator
(counterpart of maua_tpu/io/torch_ckpt.py:33-48, 158-264).

The port's modules carry the rosinality keys, so a `g_ema` state dict loads
as it is. Two things are filled in before `load_state_dict(strict=True)`:
the FIR kernel buffers (`*.blur.kernel`, `*.upsample.kernel`) when a
checkpoint lacks them, and noise buffers whose shape differs from the
widescreen geometry of `output_size` / `base_res_factor`, which are tiled from
the stored square buffer (maua_tpu/io/torch_ckpt.py:254-262).
"""

from __future__ import annotations

import re
import warnings
from typing import Any, Mapping, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..models.stylegan2 import Generator, noise_shapes

__all__ = ["infer_generator_config", "load_generator", "load_torch_checkpoint"]


def load_torch_checkpoint(path: str) -> dict[str, Any]:
    """torch.load on the CPU. Full unpickling (weights_only=False), as
    rosinality checkpoints hold an argparse Namespace: load only checkpoints
    you trust."""
    return torch.load(path, map_location="cpu", weights_only=False)


def _n_convs(sd: Mapping[str, Any]) -> int:
    return len({int(m.group(1)) for k in sd if (m := re.match(r"convs\.(\d+)\.", k))})


def infer_generator_config(state_dict: Mapping[str, Any]) -> dict[str, Any]:
    """(size, style_dim, n_mlp, channel_multiplier, constant_input,
    channel_max) from the state dict's keys and shapes."""
    sd = state_dict
    n_mlp = 0
    while f"style.{n_mlp + 1}.weight" in sd:
        n_mlp += 1
    style_dim = int(sd["style.1.weight"].shape[1])
    n_convs = _n_convs(sd)
    size = 2 ** (n_convs // 2 + 2)
    constant_input = "input.input" in sd and sd["input.input"].ndim == 4
    last_ch = int(sd[f"convs.{n_convs - 1}.conv.weight"].shape[1])
    base = {4: 512, 8: 512, 16: 512, 32: 512, 64: 256, 128: 128, 256: 64, 512: 32, 1024: 16}[size]
    channel_multiplier = max(1, last_ch // base) if size >= 64 else 2
    channel_max = max(
        int(v.shape[1]) for k, v in sd.items() if re.fullmatch(r"convs\.\d+\.conv\.weight", k)
    )
    channel_max = max(channel_max, last_ch)
    return dict(
        size=size,
        style_dim=style_dim,
        n_mlp=n_mlp,
        channel_multiplier=channel_multiplier,
        constant_input=constant_input,
        channel_max=min(channel_max, 512),
    )


def load_generator(
    checkpoint: str,
    key: str = "g_ema",
    output_size: Optional[int] = None,
    base_res_factor: float = 1,
    device: DeviceLike = None,
    dtype: torch.dtype = torch.float32,
    precision: str = "exact",
    **overrides,
) -> Generator:
    """Build a Generator from a rosinality checkpoint on `device` (default
    `cuda`; raises RuntimeError when there is none) for inference: in eval
    mode, with parameters that need no gradient.

    The checkpoint is authoritative for the architecture: an override of an
    inferred key (size, style_dim, n_mlp, channel_multiplier, constant_input,
    channel_max) that disagrees is ignored with a warning."""
    device = resolve_device(device)
    ckpt = load_torch_checkpoint(checkpoint)
    sd = dict(ckpt[key] if key in ckpt else ckpt)
    config = infer_generator_config(sd)
    for k, v in list(overrides.items()):
        if k in config:
            if v != config[k]:
                warnings.warn(f"load_generator: ignoring override {k}={v!r}; checkpoint implies {k}={config[k]!r}")
            overrides.pop(k)
    config.update(overrides)
    gen = Generator(output_size=output_size, base_res_factor=base_res_factor, dtype=dtype, precision=precision, **config)

    own = gen.state_dict()
    for name, buf in own.items():
        if name.endswith(".kernel") and name not in sd:
            sd[name] = buf
    for i, shape in enumerate(noise_shapes(config["size"], output_size, base_res_factor)):
        name = f"noises.noise_{i}"
        src = sd.get(name)
        if src is None or tuple(src.shape) != shape:
            src = src if src is not None else torch.zeros(1, 1, 2, 2)
            reps = (1, 1, -(-shape[2] // src.shape[2]), -(-shape[3] // src.shape[3]))
            sd[name] = src.repeat(reps)[:, :, : shape[2], : shape[3]]
    gen.load_state_dict(sd, strict=True)
    return gen.requires_grad_(False).to(device).eval()

"""Carry the JAX package's generator weights across to the port.

`generator_state_dict_from_jax(params, buffers)` maps the JAX Generator's
variables (nested dicts of arrays: `params["convs_3"]["conv"]["weight"]`,
`buffers["noise_0"]`, ...) onto the port's state dict, whose keys are the
rosinality ones. Layouts: linear [in, out] -> [out, in]; modulated conv
[O, I, k, k] -> [1, O, I, k, k]; `act_bias` -> `activate.bias`; noise buffers
-> `noises.noise_i`; the FIR kernel buffers of the upsampling layers are
added. Only numpy is needed on the JAX side: any array type that
`np.asarray` takes will do.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ..models.blocks import DEFAULT_BLUR_KERNEL
from ..ops.upfirdn2d import setup_filter

__all__ = ["generator_state_dict_from_jax"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def generator_state_dict_from_jax(
    params: Mapping[str, Any],
    buffers: Mapping[str, Any],
    blur_kernel: Sequence[int] = DEFAULT_BLUR_KERNEL,
) -> dict[str, torch.Tensor]:
    """JAX Generator variables -> state dict for `Generator.load_state_dict`."""
    sd: dict[str, torch.Tensor] = {}
    fir = setup_filter(list(blur_kernel), gain=4.0)  # 2x upsample gain

    def put_lin(prefix, tree):
        sd[f"{prefix}.weight"] = _t(tree["weight"]).t().contiguous()
        if "bias" in tree:
            sd[f"{prefix}.bias"] = _t(tree["bias"])

    def put_modconv(prefix, tree):
        sd[f"{prefix}.weight"] = _t(tree["weight"])[None]
        put_lin(f"{prefix}.modulation", tree["modulation"])

    def put_styled(prefix, tree):
        put_modconv(f"{prefix}.conv", tree["conv"])
        sd[f"{prefix}.noise.weight"] = _t(tree["noise"]["weight"])
        sd[f"{prefix}.activate.bias"] = _t(tree["act_bias"])

    def put_torgb(prefix, tree):
        put_modconv(f"{prefix}.conv", tree["conv"])
        sd[f"{prefix}.bias"] = _t(tree["bias"])

    for name in sorted(params["style"], key=lambda n: int(n.split("_")[1])):
        put_lin(f"style.{int(name.split('_')[1]) + 1}", params["style"][name])
    g_input = params["g_input"]
    if "input" in g_input:
        sd["input.input"] = _t(g_input["input"])
    else:
        put_lin("input.linear", g_input["linear"])
        sd["input.activate.bias"] = _t(g_input["act_bias"])
    put_styled("conv1", params["conv1"])
    put_torgb("to_rgb1", params["to_rgb1"])
    n_convs = sum(1 for k in params if k.startswith("convs_"))
    for i in range(n_convs):
        put_styled(f"convs.{i}", params[f"convs_{i}"])
        if i % 2 == 0:  # the first conv of each resolution upsamples
            sd[f"convs.{i}.conv.blur.kernel"] = fir.clone()
    for i in range(n_convs // 2):
        put_torgb(f"to_rgbs.{i}", params[f"to_rgbs_{i}"])
        sd[f"to_rgbs.{i}.upsample.kernel"] = fir.clone()
    for name, buf in buffers.items():
        sd[f"noises.{name}"] = _t(buf)
    return sd

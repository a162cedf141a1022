"""Carry the JAX package's generator and discriminator weights across to the port.

`generator_state_dict_from_jax(params, buffers)` maps the JAX Generator's
variables (nested dicts of arrays: `params["convs_3"]["conv"]["weight"]`,
`buffers["noise_0"]`, ...) onto the port's state dict, whose keys are the
rosinality ones. Layouts: linear [in, out] -> [out, in]; modulated conv
[O, I, k, k] -> [1, O, I, k, k]; `act_bias` -> `activate.bias`; noise buffers
-> `noises.noise_i`; the FIR kernel buffers of the upsampling layers are
added. `discriminator_state_dict_from_jax(params)` is the inverse of the JAX
package's `discriminator_variables_from_torch`: `from_rgb` -> `convs.0`,
`block_<log2 res>` -> `convs.1` ... from the top resolution down, a
`ConvLayer`'s conv and `act_bias` -> its Sequential indices (shifted by one
behind the downsampling blur, whose FIR kernel buffer is added). Only numpy is
needed on the JAX side: any array type that `np.asarray` takes will do.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ..models.blocks import DEFAULT_BLUR_KERNEL
from ..ops.upfirdn2d import setup_filter

__all__ = ["discriminator_state_dict_from_jax", "generator_state_dict_from_jax"]


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


def discriminator_state_dict_from_jax(
    params: Mapping[str, Any], blur_kernel: Sequence[int] = DEFAULT_BLUR_KERNEL
) -> dict[str, torch.Tensor]:
    """JAX Discriminator params -> state dict for `Discriminator.load_state_dict`."""
    sd: dict[str, torch.Tensor] = {}
    fir = setup_filter(list(blur_kernel))  # downsampling blur, gain 1

    def put_conv_layer(prefix, tree, downsample):
        idx = 1 if downsample else 0
        if downsample:
            sd[f"{prefix}.0.kernel"] = fir.clone()
        sd[f"{prefix}.{idx}.weight"] = _t(tree["conv"]["weight"])
        if "bias" in tree["conv"]:
            sd[f"{prefix}.{idx}.bias"] = _t(tree["conv"]["bias"])
        if "act_bias" in tree:
            sd[f"{prefix}.{idx + 1}.bias"] = _t(tree["act_bias"])

    put_conv_layer("convs.0", params["from_rgb"], downsample=False)
    blocks = sorted((k for k in params if k.startswith("block_")), key=lambda k: -int(k.split("_")[1]))
    for j, name in enumerate(blocks, start=1):
        block = params[name]
        put_conv_layer(f"convs.{j}.conv1", block["conv1"], downsample=False)
        put_conv_layer(f"convs.{j}.conv2", block["conv2"], downsample=True)
        if "skip" in block:
            put_conv_layer(f"convs.{j}.skip", block["skip"], downsample=True)
    put_conv_layer("final_conv", params["final_conv"], downsample=False)
    for i in (0, 1):
        tree = params[f"final_linear_{i}"]
        sd[f"final_linear.{i}.weight"] = _t(tree["weight"]).t().contiguous()
        sd[f"final_linear.{i}.bias"] = _t(tree["bias"])
    return sd

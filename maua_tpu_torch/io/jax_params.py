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
behind the downsampling blur, whose FIR kernel buffer is added).
`projection_head_state_dict_from_jax(head)` maps the contrastive projection
head's dict (`w1`, `b1`, `w2`, `b2`, optional `bw`) onto the port's
`ProjectionHead`, whose parameters keep those names and layouts.
`stylegan1_state_dict_from_jax(params, buffers)` maps the JAX StyleGAN1's
pytree (blocks by index, `epi1.style`, `noise_weight`) onto the lernapparat
G_style keys of `StyleGAN1`, noise buffers included;
`inception_state_dict_from_jax(params)` and `lpips_state_dict_from_jax(params,
net)` map the JAX feature networks onto torchvision's keys (the JAX
InceptionV3's `bn_scale` / `bn_mean` -> `bn.weight` / `bn.running_mean`;
LPIPS's `conv{i}_weight` -> `features.<torchvision index>.weight`, `lin{i}` ->
`lin{i}.model.1.weight`). `vae_state_dict_from_jax(variables, model)` maps
the flax `params` and `batch_stats` of any model of the VAE family onto
`model`'s state dict: `enc_3` -> `enc.3`, `enc1_0` -> `enc.1.0`, `final_0` ->
`final`, `BatchNorm_0` `scale` / `bias` / `mean` / `var` -> `bn.weight` /
`bn.bias` / `bn.running_mean` / `bn.running_var`, Dense `kernel` [in, out] ->
`weight` [out, in]. `lucidrains_state_dict_from_jax(params)` maps the flax
params of the lucidrains `StyleVectorizer`, `LucidrainsGenerator` or
`LucidrainsDiscriminator` onto the port's module of the same flax names: a
Dense `kernel` [in, out] -> `weight` [out, in], a Conv `kernel` HWIO ->
`weight` OIHW; `Conv2DMod`'s `weight` (OIHW in both), `initial_block` [C, 4,
4], the scalar `rezero_g` and the `codebook` [K, dim] as they are. Only numpy
is needed on the JAX side: any array
type that `np.asarray` takes will do.
"""

from __future__ import annotations

import re
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ..models.blocks import DEFAULT_BLUR_KERNEL
from ..ops.upfirdn2d import setup_filter

__all__ = [
    "discriminator_state_dict_from_jax",
    "generator_state_dict_from_jax",
    "inception_state_dict_from_jax",
    "lpips_state_dict_from_jax",
    "lucidrains_state_dict_from_jax",
    "projection_head_state_dict_from_jax",
    "stylegan1_state_dict_from_jax",
    "vae_state_dict_from_jax",
]


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


def projection_head_state_dict_from_jax(head: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX projection-head dict -> state dict for `ProjectionHead.load_state_dict`."""
    return {k: _t(head[k]) for k in ("w1", "b1", "w2", "b2", "bw") if k in head}


def stylegan1_state_dict_from_jax(params: Mapping[str, Any], buffers: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX StyleGAN1 variables -> state dict for `StyleGAN1.from_state_dict`
    (the constant as JAX holds it, widescreen or not; the noise buffers)."""
    sd: dict[str, torch.Tensor] = {}

    def put_lin(prefix, tree):
        sd[f"{prefix}.weight"] = _t(tree["weight"])
        sd[f"{prefix}.bias"] = _t(tree["bias"])

    def put_epi(prefix, tree):
        sd[f"{prefix}.top_epi.noise.weight"] = _t(tree["noise_weight"])
        put_lin(f"{prefix}.style_mod.lin", tree["style"])

    for i in range(8):
        put_lin(f"g_mapping.dense{i}", params["g_mapping"][f"dense{i}"])
    blocks = params["g_synthesis"]["blocks"]
    for i in sorted(blocks, key=int):
        b, res = blocks[i], 4 * 2 ** int(i)
        prefix = f"g_synthesis.blocks.{res}x{res}"
        convs = ("conv",) if int(i) == 0 else ("conv0_up", "conv1")
        if int(i) == 0:
            sd[f"{prefix}.const"] = _t(b["const"])
            sd[f"{prefix}.bias"] = _t(b["bias"])
        for name in convs:
            put_lin(f"{prefix}.{name}", b[name])
        put_epi(f"{prefix}.epi1", b["epi1"])
        put_epi(f"{prefix}.epi2", b["epi2"])
    put_lin("g_synthesis.torgb", params["g_synthesis"]["torgb"])
    for name, buf in buffers.items():
        sd[f"noises.{name}"] = _t(buf)
    return sd


def inception_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX InceptionV3 params -> torchvision-keyed state dict for
    `InceptionV3.load`."""
    sd: dict[str, torch.Tensor] = {}

    def walk(prefix, tree):
        if "bn_scale" in tree:
            sd[f"{prefix}.conv.weight"] = _t(tree["weight"])
            for src, dst in (("bn_scale", "weight"), ("bn_bias", "bias"), ("bn_mean", "running_mean"), ("bn_var", "running_var")):
                sd[f"{prefix}.bn.{dst}"] = _t(tree[src])
            return
        for name, sub in tree.items():
            walk(f"{prefix}.{name}" if prefix else name, sub)

    walk("", params)
    return sd


def lpips_state_dict_from_jax(params: Mapping[str, Any], net: str = "vgg") -> dict[str, torch.Tensor]:
    """JAX LPIPS params -> state dict for `LPIPS.load` (torchvision backbone
    keys and richzhang heads)."""
    conv_idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28] if net == "vgg" else [0, 3, 6, 8, 10]
    sd: dict[str, torch.Tensor] = {}
    feats = params["features"]
    for i, idx in enumerate(conv_idx):
        sd[f"features.{idx}.weight"] = _t(feats[f"conv{i}_weight"])
        sd[f"features.{idx}.bias"] = _t(feats[f"conv{i}_bias"])
    i = 0
    while f"lin{i}" in params:
        sd[f"lin{i}.model.1.weight"] = _t(params[f"lin{i}"]).reshape(1, -1, 1, 1)
        i += 1
    return sd


_VAE_MODULE_RULES = [
    (re.compile(r"^(enc|dec)(\d+)_(\d+)$"), r"\1.\2.\3"),  # SegNet blocks
    (re.compile(r"^(enc|dec)_(\d+)$"), r"\1.\2"),
    (re.compile(r"^final_0$"), "final"),
    (re.compile(r"^BatchNorm_0$"), "bn"),
]
_VAE_LEAVES = {"scale": "weight", "mean": "running_mean", "var": "running_var", "kernel": "weight"}


def vae_state_dict_from_jax(variables: Mapping[str, Any], model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """flax variables ({"params": ..., "batch_stats": ...}) of LogCoshVAE,
    ConvSegNet, VariationalConvSegNet or InceptionVAE -> a state dict for the
    port's `model`; KeyError / ValueError when the keys or shapes differ."""
    sd: dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, path + [k])
                continue
            parts = []
            for name in path:
                for pattern, repl in _VAE_MODULE_RULES:
                    name = pattern.sub(repl, name)
                parts.append(name)
            leaf = _VAE_LEAVES.get(k, k) if path and path[-1] == "BatchNorm_0" or k == "kernel" else k
            t = _t(v)
            sd[".".join(parts + [leaf])] = t.t().contiguous() if k == "kernel" else t

    walk(variables["params"], [])
    walk(variables.get("batch_stats", {}), [])
    want = model.state_dict()
    if set(sd) != set(want):
        raise KeyError(f"missing {sorted(set(want) - set(sd))}, unexpected {sorted(set(sd) - set(want))}")
    for k, v in sd.items():
        if v.shape != want[k].shape:
            raise ValueError(f"{k}: {tuple(v.shape)} from JAX, {tuple(want[k].shape)} in the model")
    return sd


def lucidrains_state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax params of a lucidrains S, G or D -> a state dict for the port's
    `StyleVectorizer`, `LucidrainsGenerator` or `LucidrainsDiscriminator`."""
    sd: dict[str, torch.Tensor] = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, path + [k])
                continue
            t = _t(v)
            if k == "kernel":  # Dense [in, out] -> [out, in]; Conv HWIO -> OIHW
                t = t.t() if t.ndim == 2 else t.permute(3, 2, 0, 1)
                k = "weight"
            sd[".".join(path + [k])] = t.contiguous()

    walk(params, [])
    return sd

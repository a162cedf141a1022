"""Seeded weights of a configuration, made on the device in a few calls.

The benchmark makes every weight itself and hands the same dict (rosinality
state-dict keys) to the program and to the reference. All normal draws of a
network come from one `torch.randn` on the device, cut into the leaves in a
fixed order, so the same seed gives the same weights on any run.

`kind="init"` is rosinality's initialisation (what training starts from):
N(0, 1) conv and linear weights (the mapping's divided by lr_mlp), modulation
biases 1, other biases and the noise weights 0, N(0, 1) noise buffers.
`kind="trained"` stands in for a trained generator, whose frames fill the
[-1, 1] range without saturating and whose noise inputs matter: biases and
noise weights drawn N(0, spread^2) and the ToRGB weights scaled by
`to_rgb_gain` (all three from the traffic file).
"""

from __future__ import annotations

import math

import torch

from .flops import channels, resolutions, shapes_of


def generator_leaves(config: dict) -> list[tuple[str, tuple, str]]:
    """(key, shape, init) of every generator tensor but the FIR kernels;
    init is "normal", "mapping", "rgb", "one", "zero", "bias" or "noise_w"."""
    s = shapes_of(config)
    ch, S = channels(s), s.style_dim
    out = []
    for i in range(1, s.n_mlp + 1):
        out += [(f"style.{i}.weight", (S, S), "mapping"), (f"style.{i}.bias", (S,), "zero")]
    out.append(("input.input", (1, ch[4], 4, 4), "normal"))

    def styled(key, cin, cout):
        return [(f"{key}.conv.weight", (1, cout, cin, 3, 3), "normal"),
                (f"{key}.conv.modulation.weight", (cin, S), "normal"), (f"{key}.conv.modulation.bias", (cin,), "one"),
                (f"{key}.noise.weight", (1,), "noise_w"), (f"{key}.activate.bias", (cout,), "bias")]

    def rgb(key, cin):
        return [(f"{key}.conv.weight", (1, 3, cin, 1, 1), "rgb"),
                (f"{key}.conv.modulation.weight", (cin, S), "normal"), (f"{key}.conv.modulation.bias", (cin,), "one"),
                (f"{key}.bias", (1, 3, 1, 1), "bias")]

    out += styled("conv1", ch[4], ch[4]) + rgb("to_rgb1", ch[4])
    prev = ch[4]
    for k, r in enumerate(resolutions(s)):
        out += styled(f"convs.{2 * k}", prev, ch[r]) + styled(f"convs.{2 * k + 1}", ch[r], ch[r])
        out += rgb(f"to_rgbs.{k}", ch[r])
        prev = ch[r]
    n_layers = 2 * len(resolutions(s)) + 1
    for i in range(n_layers):
        r = 2 ** ((i + 5) // 2)
        out.append((f"noises.noise_{i}", (1, 1, r, r), "normal"))
    return out


def discriminator_leaves(config: dict) -> list[tuple[str, tuple, str]]:
    s = shapes_of(config)
    ch = channels(s)
    out = [("convs.0.0.weight", (ch[s.size], 3, 1, 1), "normal"), ("convs.0.1.bias", (ch[s.size],), "zero")]
    r, i = s.size, 1
    while r > 4:
        c, c2 = ch[r], ch[r // 2]
        out += [(f"convs.{i}.conv1.0.weight", (c, c, 3, 3), "normal"), (f"convs.{i}.conv1.1.bias", (c,), "zero"),
                (f"convs.{i}.conv2.1.weight", (c2, c, 3, 3), "normal"), (f"convs.{i}.conv2.2.bias", (c2,), "zero"),
                (f"convs.{i}.skip.1.weight", (c2, c, 1, 1), "normal")]
        r, i = r // 2, i + 1
    c4 = ch[4]
    return out + [("final_conv.0.weight", (c4, c4 + 1, 3, 3), "normal"), ("final_conv.1.bias", (c4,), "zero"),
                  ("final_linear.0.weight", (c4, c4 * 16), "normal"), ("final_linear.0.bias", (c4,), "zero"),
                  ("final_linear.1.weight", (1, c4), "normal"), ("final_linear.1.bias", (1,), "zero")]


def make(leaves: list[tuple[str, tuple, str]], generator: torch.Generator, device, kind: str = "init",
         spread: float = 0.0, to_rgb_gain: float = 1.0, lr_mlp: float = 0.01) -> dict[str, torch.Tensor]:
    """The weights of `leaves` from one normal draw on the device."""
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    flat = torch.randn(sum(sizes), generator=generator, device=device)
    out, at = {}, 0
    for (key, shape, init), n in zip(leaves, sizes):
        x = flat[at: at + n].view(shape)
        at += n
        if init == "mapping":
            x = x / lr_mlp
        elif init == "rgb":
            x = x * (to_rgb_gain if kind == "trained" else 1.0)
        elif init == "one":
            x = torch.ones_like(x)
        elif init in ("bias", "noise_w"):
            x = x * spread if kind == "trained" else torch.zeros_like(x)
        elif init == "zero":
            x = torch.zeros_like(x)
        out[key] = x.clone()
    return out


def generator_weights(config: dict, seed: int, device, kind: str = "init", spread: float = 0.0,
                      to_rgb_gain: float = 1.0) -> dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    return make(generator_leaves(config), gen, device, kind, spread, to_rgb_gain, config.get("lr_mlp", 0.01))


def discriminator_weights(config: dict, seed: int, device) -> dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    return make(discriminator_leaves(config), gen, device)


def load(module: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copy `weights` into the module's tensors of the same keys. Every
    parameter and buffer has to be covered but the FIR kernels, which the
    module derives itself."""
    state = module.state_dict()
    missing = [k for k in state if k not in weights and not k.endswith(".kernel")]
    unknown = [k for k in weights if k not in state]
    if missing or unknown:
        raise KeyError(f"weights do not match the module: missing {missing[:5]}, unknown {unknown[:5]}")
    with torch.no_grad():
        for k, v in weights.items():
            state[k].copy_(v)

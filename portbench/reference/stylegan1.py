"""A plain fp32 StyleGAN1 generator (Karras et al. 2019, arXiv:1812.04948) in
plain `torch`, written after NVlabs' `stylegan/training/networks_stylegan.py`
(`G_style`, `G_mapping`, `G_synthesis`).

It imports nothing of the program under test and nothing of JAX. Every
function takes its weights as a dict keyed by the lernapparat G_style names
(`g_mapping.dense3.weight`, `g_synthesis.blocks.64x64.conv0_up.bias`,
`g_synthesis.blocks.8x8.epi1.style_mod.lin.weight`, ...; the stored noise maps
`noises.noise_{i}`), the same dict the benchmark writes into the checkpoint
that the program loads. Weights are stored as NVlabs stores them with
use_wscale: N(0, 1 / lrmul^2) at init, scaled at run time by
gain / sqrt(fan_in) x lrmul.

mapping: pixel norm, then 8 dense layers (gain sqrt 2, lr multiplier 0.01)
each followed by leaky ReLU 0.2, broadcast to 18 layers. synthesis: the
constant plus its bias, then per layer conv -> blur (upscale layers only) ->
noise x weight -> bias -> leaky ReLU 0.2 -> instance norm -> x * (s0 + 1) + s1
with s = dense(w) (gain 1). An upscale layer is nearest 2x + 3x3 conv below a
128^2 output and, from 128^2 (`fused_scale='auto'`), the stride-2 transposed
conv of the 3x3 weight summed over its four 1-pixel shifts; the blur is
[1, 2, 1] x [1, 2, 1] / 16 with zero padding 1. torgb: a 1x1 conv, gain 1, and
its bias. Truncation lerps the first 8 of the 18 layers toward the mean w.

Departures from NVlabs, each on purpose:
* the instance norm's epsilon is lernapparat's 1e-5 (NVlabs: 1e-8);
* one noise map per block feeds both of its layers, as render()'s interface
  gives them (NVlabs: one map per layer);
* the benchmark calls it in blocks of 8 frames (NVlabs: minibatch 4-8);
* truncation takes a per-sample [B] psi as well as a float.
TF32 stays off: the callers hold `precision(False)` over every call.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)
N_LATENT = 18
TRUNCATION_CUTOFF = 8
FUSED_FROM = 128  # output resolution from which the upscale conv is fused
IN_EPS = 1e-5


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.2 * x)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, gain: float, lrmul: float = 1.0) -> torch.Tensor:
    """NVlabs `dense` + `apply_bias`: w [out, in] stored, scaled by gain / sqrt(in) x lrmul."""
    return x @ (w * (gain / math.sqrt(w.shape[1]) * lrmul)).t() + b * lrmul


def conv(x: torch.Tensor, w: torch.Tensor, gain: float = SQRT2) -> torch.Tensor:
    """NVlabs `conv2d` (SAME padding, no bias): w [out, in, k, k] stored."""
    return F.conv2d(x, w * (gain / math.sqrt(w[0].numel())), padding=w.shape[-1] // 2)


def upscale_conv(x: torch.Tensor, w: torch.Tensor, gain: float = SQRT2) -> torch.Tensor:
    """NVlabs `upscale2d_conv2d` (no bias): nearest 2x then the 3x3 conv below
    a 128^2 output; from 128^2 the fused form, a stride-2 transposed conv (TF's
    conv2d_transpose, SAME) of the 3x3 weight padded to 5x5 and summed over
    its four 1-pixel shifts."""
    if 2 * min(x.shape[2:]) < FUSED_FROM:
        return conv(x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3), w, gain)
    w = w * (gain / math.sqrt(w[0].numel()))
    w = F.pad(w, (1, 1, 1, 1))
    w = w[..., 1:, 1:] + w[..., :-1, 1:] + w[..., 1:, :-1] + w[..., :-1, :-1]  # [out, in, 4, 4]
    return F.conv_transpose2d(x, w.transpose(0, 1), stride=2, padding=1)


def blur(x: torch.Tensor) -> torch.Tensor:
    """NVlabs `blur2d` with f = [1, 2, 1], normalised: depthwise, zero padding 1."""
    f = torch.tensor([1.0, 2.0, 1.0], device=x.device)
    f = (f[:, None] * f[None, :]) / 16.0
    c = x.shape[1]
    return F.conv2d(x, f.expand(c, 1, 3, 3), padding=1, groups=c)


def instance_norm(x: torch.Tensor, eps: float = IN_EPS) -> torch.Tensor:
    x = x - x.mean(dim=(2, 3), keepdim=True)
    return x * torch.rsqrt(x.square().mean(dim=(2, 3), keepdim=True) + eps)


def epilogue(p: dict, key: str, x: torch.Tensor, w: torch.Tensor, noise: torch.Tensor,
             bias: torch.Tensor) -> torch.Tensor:
    """NVlabs `layer_epilogue`: noise, bias, leaky ReLU, instance norm, style."""
    x = x + p[f"{key}.top_epi.noise.weight"].reshape(1, -1, 1, 1) * noise
    x = lrelu(x + bias.reshape(1, -1, 1, 1))
    x = instance_norm(x)
    s = dense(w, p[f"{key}.style_mod.lin.weight"], p[f"{key}.style_mod.lin.bias"], gain=1.0)
    s = s.reshape(w.shape[0], 2, x.shape[1], 1, 1)
    return x * (s[:, 0] + 1.0) + s[:, 1]


def mapping(p: dict, z: torch.Tensor, n_mlp: int = 8, lrmul: float = 0.01) -> torch.Tensor:
    """z [B, 512] -> w [B, 512]."""
    x = z * torch.rsqrt(z.square().mean(dim=1, keepdim=True) + 1e-8)
    for i in range(n_mlp):
        x = lrelu(dense(x, p[f"g_mapping.dense{i}.weight"], p[f"g_mapping.dense{i}.bias"], SQRT2, lrmul))
    return x


def mean_latent(p: dict, z: torch.Tensor) -> torch.Tensor:
    return mapping(p, z).mean(dim=0, keepdim=True)


def truncate(wplus: torch.Tensor, psi, mean: torch.Tensor, cutoff: int = TRUNCATION_CUTOFF) -> torch.Tensor:
    """G_style's truncation: lerp(mean, w, psi) on the first `cutoff` layers."""
    psi = torch.as_tensor(psi, dtype=wplus.dtype, device=wplus.device).reshape(-1).expand(wplus.shape[0])
    coef = torch.ones(wplus.shape[:2], dtype=wplus.dtype, device=wplus.device)
    coef[:, :cutoff] = psi[:, None]
    m = mean.reshape(1, 1, -1)
    return m + coef[..., None] * (wplus - m)


def synthesis(p: dict, wplus: torch.Tensor, noise: Sequence[torch.Tensor], size: int) -> torch.Tensor:
    """Image [B, 3, size, size] from W+ [B, 18, 512]; `noise` one [B or 1, 1,
    r, r] map per block (4^2 .. size^2)."""
    b = wplus.shape[0]
    top = "g_synthesis.blocks.4x4"
    x = p[f"{top}.const"].expand(b, -1, -1, -1)
    x = epilogue(p, f"{top}.epi1", x, wplus[:, 0], noise[0], p[f"{top}.bias"])
    x = epilogue(p, f"{top}.epi2", conv(x, p[f"{top}.conv.weight"]), wplus[:, 1], noise[0], p[f"{top}.conv.bias"])
    for i in range(1, int(math.log2(size)) - 1):
        r = 4 * 2**i
        key = f"g_synthesis.blocks.{r}x{r}"
        x = blur(upscale_conv(x, p[f"{key}.conv0_up.weight"]))
        x = epilogue(p, f"{key}.epi1", x, wplus[:, 2 * i], noise[i], p[f"{key}.conv0_up.bias"])
        x = conv(x, p[f"{key}.conv1.weight"])
        x = epilogue(p, f"{key}.epi2", x, wplus[:, 2 * i + 1], noise[i], p[f"{key}.conv1.bias"])
    rgb = conv(x, p["g_synthesis.torgb.weight"], gain=1.0)
    return rgb + p["g_synthesis.torgb.bias"].reshape(1, -1, 1, 1)

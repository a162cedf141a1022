"""A plain fp32 StyleGAN2 (config F, Karras et al. 2020, arXiv:1912.04958) in
plain `torch`, written after rosinality's stylegan2-pytorch `model.py`.

It imports nothing of the program under test and nothing of JAX. Every
function takes its weights as a dict keyed by the rosinality state-dict names
(`style.1.weight`, `convs.3.conv.weight`, `convs.1.conv2.1.weight`, ...), the
same dict the benchmark loads into the program, so both sides start from one
set of numbers.

Departures from the reference repository, each on purpose:
* `upfirdn2d` and the fused bias + leaky-ReLU are rosinality's native
  (plain PyTorch) forms, not its CUDA extensions;
* the modulated conv is rosinality's `fused=False` form (activations scaled
  by the style, the shared weight, the demodulation applied to the output),
  which its repository keeps beside the grouped per-sample conv: the same
  function by linearity, and far cheaper to differentiate twice;
* noise is always passed in (a list of one tensor per layer), never drawn;
* truncation takes a per-sample [B] vector as well as a float.
TF32 stays off: the callers hold `precision(False)`, which sets cuDNN's and
cuBLAS's switches, over every forward and backward.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Sequence

import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)
BLUR = (1, 3, 3, 1)


@contextlib.contextmanager
def precision(tf32: bool) -> Iterator[None]:
    """Hold cuDNN's and cuBLAS's TF32 switches at `tf32` inside the block."""
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def make_kernel(k: Sequence[int], factor: int = 1) -> torch.Tensor:
    k = torch.tensor(k, dtype=torch.float32)
    k = k[None, :] * k[:, None]
    return k / k.sum() * factor**2


# ---------------------------------------------------------------- ops (rosinality's native forms)
def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up: int = 1, down: int = 1, pad=(0, 0)) -> torch.Tensor:
    """rosinality `upfirdn2d_native`: zero-stuff, pad (negative crops), true
    convolution with `kernel`, keep every `down`-th sample."""
    pad0, pad1 = pad
    _, channel, in_h, in_w = x.shape
    kernel = kernel.to(x)
    kh, kw = kernel.shape
    out = x.reshape(-1, in_h, 1, in_w, 1, 1)
    out = F.pad(out, [0, 0, 0, up - 1, 0, 0, 0, up - 1])
    out = out.view(-1, in_h * up, in_w * up, 1)
    out = F.pad(out, [0, 0, max(pad0, 0), max(pad1, 0), max(pad0, 0), max(pad1, 0)])
    out = out[:, max(-pad0, 0): out.shape[1] - max(-pad1, 0), max(-pad0, 0): out.shape[2] - max(-pad1, 0), :]
    out = out.permute(0, 3, 1, 2).reshape(-1, 1, in_h * up + pad0 + pad1, in_w * up + pad0 + pad1)
    w = torch.flip(kernel, [0, 1]).view(1, 1, kh, kw)
    out = F.conv2d(out, w)
    out = out[:, :, ::down, ::down]
    return out.reshape(-1, channel, out.shape[2], out.shape[3])


def bias_lrelu(x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """rosinality `fused_leaky_relu` native: leaky_relu(x + b, 0.2) * sqrt 2."""
    if bias is not None:
        x = x + bias.reshape(1, -1, *([1] * (x.ndim - 2)))
    return F.leaky_relu(x, 0.2) * SQRT2


def equal_linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], lr_mul: float = 1.0,
                 activate: bool = False) -> torch.Tensor:
    scale = lr_mul / math.sqrt(w.shape[1])
    out = F.linear(x, w * scale)
    bias = None if b is None else b * lr_mul
    if activate:
        return bias_lrelu(out, bias)
    return out if bias is None else out + bias


# ---------------------------------------------------------------- generator
def mapping(p: dict, z: torch.Tensor, n_mlp: int = 8, lr_mlp: float = 0.01) -> torch.Tensor:
    x = z * torch.rsqrt(z.square().mean(dim=1, keepdim=True) + 1e-8)
    for i in range(1, n_mlp + 1):
        x = equal_linear(x, p[f"style.{i}.weight"], p[f"style.{i}.bias"], lr_mlp, activate=True)
    return x


def mean_latent(p: dict, z: torch.Tensor, n_mlp: int = 8) -> torch.Tensor:
    return mapping(p, z, n_mlp).mean(dim=0, keepdim=True)


def modulated_conv(p: dict, key: str, x: torch.Tensor, style: torch.Tensor, demodulate: bool = True,
                   upsample: bool = False) -> torch.Tensor:
    """rosinality `ModulatedConv2d` with `fused=False`: the input scaled by
    the style, one conv with the shared weight, the output scaled by the
    demodulation coefficients of the per-sample weight."""
    weight = p[f"{key}.weight"][0]  # [O, I, k, k]
    out_ch, in_ch, k, _ = weight.shape
    batch = x.shape[0]
    weight = weight / math.sqrt(in_ch * k * k)
    s = equal_linear(style, p[f"{key}.modulation.weight"], p[f"{key}.modulation.bias"])
    if demodulate:
        w = weight[None] * s.view(batch, 1, in_ch, 1, 1)
        dcoefs = (w.square().sum((2, 3, 4)) + 1e-8).rsqrt()
    x = x * s.reshape(batch, in_ch, 1, 1)
    if upsample:
        out = F.conv_transpose2d(x, weight.transpose(0, 1), padding=0, stride=2)
        out = upfirdn2d(out, make_kernel(BLUR, 2), pad=(1, 1))
    else:
        out = F.conv2d(x, weight, padding=k // 2)
    if demodulate:
        out = out * dcoefs.view(batch, -1, 1, 1)
    return out


def styled_conv(p: dict, key: str, x, style, noise, upsample=False):
    out = modulated_conv(p, f"{key}.conv", x, style, upsample=upsample)
    out = out + p[f"{key}.noise.weight"] * noise
    return bias_lrelu(out, p[f"{key}.activate.bias"])


def to_rgb(p: dict, key: str, x, style, skip=None):
    out = modulated_conv(p, f"{key}.conv", x, style, demodulate=False) + p[f"{key}.bias"]
    if skip is not None:
        out = out + upfirdn2d(skip, make_kernel(BLUR, 2), up=2, pad=(2, 1))
    return out


def n_latent(size: int) -> int:
    return int(math.log2(size)) * 2 - 2


def synthesis(p: dict, wplus: torch.Tensor, noise: Sequence[torch.Tensor], size: int) -> torch.Tensor:
    """Image [B, 3, size, size] from W+ [B, n_latent, 512]; `noise` one
    [B or 1, 1, h, w] tensor per layer."""
    log_size = int(math.log2(size))
    batch = wplus.shape[0]
    out = p["input.input"].expand(batch, -1, -1, -1)
    out = styled_conv(p, "conv1", out, wplus[:, 0], noise[0])
    skip = to_rgb(p, "to_rgb1", out, wplus[:, 1])
    i = 1
    for k in range(log_size - 2):
        out = styled_conv(p, f"convs.{2 * k}", out, wplus[:, i], noise[2 * k + 1], upsample=True)
        out = styled_conv(p, f"convs.{2 * k + 1}", out, wplus[:, i + 1], noise[2 * k + 2])
        skip = to_rgb(p, f"to_rgbs.{k}", out, wplus[:, i + 2], skip)
        i += 2
    return skip


def truncate(wplus: torch.Tensor, truncation, mean: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(truncation, dtype=wplus.dtype, device=wplus.device).reshape(-1)
    t = t.expand(wplus.shape[0])[:, None, None]
    return mean.reshape(1, 1, -1) + t * (wplus - mean.reshape(1, 1, -1))


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] in [-1, 1] -> [B, H, W, 3] uint8, rounded to nearest."""
    img = (img.clamp(-1.0, 1.0) + 1.0) * 127.5 + 0.5
    return img.to(torch.uint8).permute(0, 2, 3, 1)


# ---------------------------------------------------------------- discriminator
def conv_layer(p: dict, key: str, x: torch.Tensor, kernel_size: int, downsample: bool = False,
               activate: bool = True) -> torch.Tensor:
    """rosinality `ConvLayer`: [Blur] EqualConv2d [FusedLeakyReLU]."""
    idx = 0
    if downsample:
        pad = (len(BLUR) - 2) + (kernel_size - 1)
        x = upfirdn2d(x, make_kernel(BLUR), pad=((pad + 1) // 2, pad // 2))
        idx = 1
    weight = p[f"{key}.{idx}.weight"]
    scale = 1.0 / math.sqrt(weight.shape[1] * kernel_size**2)
    stride, padding = (2, 0) if downsample else (1, kernel_size // 2)
    out = F.conv2d(x, weight * scale, stride=stride, padding=padding)
    if activate:
        return bias_lrelu(out, p[f"{key}.{idx + 1}.bias"])
    bias = p.get(f"{key}.{idx}.bias")
    return out if bias is None else out + bias.reshape(1, -1, 1, 1)


def minibatch_stddev(x: torch.Tensor, group_size: int = 4, n_feat: int = 1) -> torch.Tensor:
    batch, channel, height, width = x.shape
    group = min(batch, group_size)
    y = x.view(group, -1, n_feat, channel // n_feat, height, width)
    y = torch.sqrt(y.var(0, unbiased=False) + 1e-8)
    y = y.mean([2, 3, 4], keepdim=True).squeeze(2)
    y = y.repeat(group, 1, height, width)
    return torch.cat([x, y], 1)


def discriminator(p: dict, x: torch.Tensor, size: int) -> torch.Tensor:
    """Logits [B, 1] of images [B, 3, size, size]."""
    log_size = int(math.log2(size))
    out = conv_layer(p, "convs.0", x, 1)
    for i in range(1, log_size - 1):
        key = f"convs.{i}"
        h = conv_layer(p, f"{key}.conv1", out, 3)
        h = conv_layer(p, f"{key}.conv2", h, 3, downsample=True)
        skip = conv_layer(p, f"{key}.skip", out, 1, downsample=True, activate=False)
        out = (h + skip) / SQRT2
    out = minibatch_stddev(out)
    out = conv_layer(p, "final_conv", out, 3)
    out = out.reshape(out.shape[0], -1)
    out = equal_linear(out, p["final_linear.0.weight"], p["final_linear.0.bias"], activate=True)
    return equal_linear(out, p["final_linear.1.weight"], p["final_linear.1.bias"])

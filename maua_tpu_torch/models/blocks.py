"""StyleGAN2 generator and discriminator blocks in PyTorch (counterpart of
maua_tpu/models/blocks.py:46-627; the discriminator's `EqualConv2d`,
`Downsample`, `ConvLayer`, `ResBlock` and `minibatch_stddev` run the native
path only, no space-to-depth).

Parameter and buffer names are the rosinality state-dict keys
(`conv.weight` [1, O, I, k, k], `conv.modulation.weight` [out, in],
`activate.bias`, `noise.weight`, `blur.kernel`, ...), so a rosinality `g_ema`
or `d` loads with `load_state_dict(strict=True)`. A discriminator `ConvLayer`
is a Sequential `[Blur?] EqualConv2d [FusedLeakyReLU?]`, so its keys are
`convs.1.conv2.0.kernel`, `convs.1.conv2.1.weight`, `convs.1.conv2.2.bias`. The math follows the JAX blocks:
`ModulatedConv2d` scales the input by the style, runs one batched conv with the
shared weight, and scales the output by the demodulation factor, which is
exact by linearity of the conv (no per-sample weights, no grouped conv).

Precision policy (maua_tpu/models/blocks.py:46-64, 283-291):
* "exact": fp32 with TF32 off in cuDNN and cuBLAS for the whole forward;
* "fast": as exact, except the demodulated body convs whose input is larger
  than 64x64, which may run in TF32;
* a bf16 synthesis dtype runs the convs in bf16, while the demodulation
  factors stay fp32.
The Generator's and the Discriminator's forwards set the policy with
`tf32(...)`, which restores the global switches when it leaves. A backward
runs after the forward has left, so training holds `tf32(False, False)` over
each phase's forward and backward together (train/step.py).

`EqualConv2d` and `ModulatedConv2d` convolve through ops/conv.py: without a
gradient to record, `F.conv2d` / `F.conv_transpose2d`; with one, autograd
Functions whose double backward (R1, the path penalty) is cuDNN's dgrad and
wgrad. The bias is added outside the conv.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv
from ..ops.fused_act import fused_leaky_relu
from ..ops.upfirdn2d import setup_filter, upfirdn2d
from ..parallel.mesh import gather_batch, local_rows

DEFAULT_BLUR_KERNEL = (1, 3, 3, 1)
PRECISIONS = ("exact", "fast")


@contextlib.contextmanager
def tf32(conv: bool, matmul: bool):
    """Set cuDNN's (conv) and cuBLAS's (matmul) TF32 switches inside the
    block and restore the previous values when it leaves."""
    old = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = conv
    torch.backends.cuda.matmul.allow_tf32 = matmul
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """x * rsqrt(mean(x^2 over channels) + eps)."""
    return x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + eps)


class PixelNorm(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_norm(x)


class FusedLeakyReLU(nn.Module):
    """Learned bias + scaled leaky-ReLU (`activate.bias` in the state dict);
    `bias=False` applies the activation alone."""

    def __init__(self, channel: int, bias: bool = True):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channel)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_leaky_relu(x, self.bias)


class EqualLinear(nn.Module):
    """Equalized-lr linear: weight [out, in] drawn N(0,1)/lr_mul, applied with
    scale lr_mul/sqrt(in); bias applied times lr_mul."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        bias: bool = True,
        bias_init: float = 0.0,
        lr_mul: float = 1.0,
        activation: Optional[str] = None,
    ):
        super().__init__()
        if activation not in (None, "fused_lrelu"):
            raise ValueError(f"activation must be None or 'fused_lrelu', got {activation!r}")
        self.weight = nn.Parameter(torch.randn(out_dim, in_dim) / lr_mul)
        self.bias = nn.Parameter(torch.full((out_dim,), float(bias_init))) if bias else None
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.lr_mul = lr_mul
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.linear(x, (self.weight * self.scale).to(x.dtype))
        bias = None if self.bias is None else self.bias * self.lr_mul
        if self.activation == "fused_lrelu":
            return fused_leaky_relu(out, bias)
        return out if bias is None else out + bias.to(out.dtype)


class EqualConv2d(nn.Module):
    """Equalized-lr conv: weight [O, I, k, k] drawn N(0,1), applied with scale
    1/sqrt(I*k*k), in the input's dtype."""

    def __init__(
        self, in_channel: int, out_channel: int, kernel_size: int, stride: int = 1, padding: int = 0,
        bias: bool = True,
    ):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(out_channel, in_channel, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channel)) if bias else None
        self.scale = 1.0 / math.sqrt(in_channel * kernel_size**2)
        self.stride = stride
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = conv.conv2d(x, (self.weight * self.scale).to(x.dtype), stride=self.stride, padding=self.padding)
        return out if self.bias is None else out + self.bias.to(out.dtype).reshape(1, -1, 1, 1)


class Blur(nn.Module):
    """FIR blur through upfirdn2d; the kernel carries the upsample gain."""

    def __init__(self, kernel: Sequence[int], pad: tuple[int, int], upsample_factor: int = 1):
        super().__init__()
        self.register_buffer("kernel", setup_filter(list(kernel), gain=float(upsample_factor**2)))
        self.pad = tuple(pad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upfirdn2d(x, self.kernel, pad=self.pad)


class Upsample(nn.Module):
    """2x FIR upsample."""

    def __init__(self, kernel: Sequence[int] = DEFAULT_BLUR_KERNEL, factor: int = 2):
        super().__init__()
        self.register_buffer("kernel", setup_filter(list(kernel), gain=float(factor**2)))
        self.factor = factor
        p = len(kernel) - factor
        self.pad = ((p + 1) // 2 + factor - 1, p // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upfirdn2d(x, self.kernel, up=self.factor, down=1, pad=self.pad)


class Downsample(nn.Module):
    """2x FIR downsample."""

    def __init__(self, kernel: Sequence[int] = DEFAULT_BLUR_KERNEL, factor: int = 2):
        super().__init__()
        self.register_buffer("kernel", setup_filter(list(kernel)))
        self.factor = factor
        p = len(kernel) - factor
        self.pad = ((p + 1) // 2, p // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upfirdn2d(x, self.kernel, up=1, down=self.factor, pad=self.pad)


class ModulatedConv2d(nn.Module):
    """Style-modulated (and optionally demodulated) conv:
        y_b = demod_b * conv(x_b * style_b, scale * W),
        demod_b[o] = rsqrt(sum_i style_b[i]^2 * sum_k (scale * W[o, i, k])^2 + eps).
    The upsample variant is a stride-2 transposed conv followed by a blur."""

    def __init__(
        self,
        in_channel: int,
        out_channel: int,
        kernel_size: int,
        style_dim: int,
        demodulate: bool = True,
        upsample: bool = False,
        blur_kernel: Sequence[int] = DEFAULT_BLUR_KERNEL,
        eps: float = 1e-8,
        precision: str = "exact",
    ):
        super().__init__()
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.weight = nn.Parameter(torch.randn(1, out_channel, in_channel, kernel_size, kernel_size))
        self.modulation = EqualLinear(style_dim, in_channel, bias_init=1.0)
        self.scale = 1.0 / math.sqrt(in_channel * kernel_size**2)
        self.kernel_size = kernel_size
        self.demodulate = demodulate
        self.upsample = upsample
        self.eps = eps
        self.precision = precision
        if upsample:
            factor = 2
            p = (len(blur_kernel) - factor) - (kernel_size - 1)
            self.blur = Blur(blur_kernel, pad=((p + 1) // 2 + factor - 1, p // 2 + 1), upsample_factor=factor)

    def forward(self, x: torch.Tensor, style: torch.Tensor, weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`weight` [1, O', I, k, k] stands in for `self.weight` (a tensor-parallel
        rank's slice of the out-channels); the output then has O' channels."""
        h, w = x.shape[-2:]
        s = self.modulation(style)  # [B, in]
        weight = (self.weight if weight is None else weight)[0] * self.scale  # [O, I, k, k], fp32
        if self.demodulate:
            # in the parameters' dtype (fp32) whatever the synthesis dtype:
            # rsqrt of near-cancelling sums
            w_sq = weight.square().sum(dim=(2, 3))  # [O, I]
            demod = torch.rsqrt(s.to(w_sq.dtype).square() @ w_sq.t() + self.eps)  # [B, O]
        x = x * s[:, :, None, None].to(x.dtype)
        w_shared = weight.to(x.dtype)
        fast = self.precision == "fast" and self.demodulate and h * w > 64 * 64
        with tf32(conv=fast, matmul=False):
            if self.upsample:
                out = conv.conv_transpose2d(x, w_shared.transpose(0, 1), stride=2)
            else:
                out = conv.conv2d(x, w_shared, padding=self.kernel_size // 2)
        if self.demodulate:
            out = out * demod[:, :, None, None].to(out.dtype)
        if self.upsample:
            out = self.blur(out)
        return out


class NoiseInjection(nn.Module):
    """out = x + weight * noise; noise [B or 1, 1, H, W], drawn from `rng`
    when None."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))

    def forward(
        self, x: torch.Tensor, noise: Optional[torch.Tensor] = None, rng: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        if noise is None:
            b, _, h, w = x.shape
            noise = torch.randn((b, 1, h, w), generator=rng, device=x.device, dtype=x.dtype)
        return x + self.weight.to(x.dtype) * noise.to(x.dtype)


class ConstantInput(nn.Module):
    """Learned constant 4x4 input (`input.input` [1, C, 4, 4])."""

    def __init__(self, channel: int, size: int = 4):
        super().__init__()
        self.input = nn.Parameter(torch.randn(1, channel, size, size))

    def forward(self, batch: int) -> torch.Tensor:
        return self.input.expand(batch, -1, -1, -1)


class LatentInput(nn.Module):
    """Latent-mapped 4x4 input (the `--noconst` model); takes latent[:, 0]."""

    def __init__(self, style_dim: int, channel: int, size: int = 4):
        super().__init__()
        self.linear = EqualLinear(style_dim, channel * size * size, activation="fused_lrelu")
        self.activate = FusedLeakyReLU(channel * size * size)
        self.channel = channel
        self.size = size

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        out = self.activate(self.linear(latent[:, 0]))
        return out.reshape(latent.shape[0], self.channel, self.size, self.size)


def apply_bends(x: torch.Tensor, layer_id: int, bends: Sequence[Any]) -> torch.Tensor:
    """Apply each bend aimed at `layer_id`. A bend is (layer_id, fn) or
    {"layer": id, "transform": fn}; fn maps an activation [B, C, H, W] to a
    new one."""
    for bend in bends or ():
        bid, fn = (bend["layer"], bend["transform"]) if isinstance(bend, dict) else bend
        if bid == layer_id:
            x = fn(x)
    return x


class StyledConv(nn.Module):
    """ModulatedConv2d -> NoiseInjection -> fused bias + leaky-ReLU -> bends."""

    def __init__(
        self,
        in_channel: int,
        out_channel: int,
        kernel_size: int,
        style_dim: int,
        upsample: bool = False,
        blur_kernel: Sequence[int] = DEFAULT_BLUR_KERNEL,
        demodulate: bool = True,
        layer_id: int = -1,
        precision: str = "exact",
    ):
        super().__init__()
        self.conv = ModulatedConv2d(
            in_channel, out_channel, kernel_size, style_dim,
            demodulate=demodulate, upsample=upsample, blur_kernel=blur_kernel, precision=precision,
        )
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_channel)
        self.layer_id = layer_id

    def forward(
        self,
        x: torch.Tensor,
        style: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
        bends: Sequence[Any] = (),
        rng: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        out = self.noise(self.conv(x, style), noise, rng)
        return apply_bends(self.activate(out), self.layer_id, bends)


class ToRGB(nn.Module):
    """1x1 modulated, non-demodulated conv to RGB, plus the upsampled skip."""

    def __init__(
        self,
        in_channel: int,
        style_dim: int,
        upsample: bool = True,
        blur_kernel: Sequence[int] = DEFAULT_BLUR_KERNEL,
    ):
        super().__init__()
        if upsample:
            self.upsample = Upsample(blur_kernel)
        self.conv = ModulatedConv2d(in_channel, 3, 1, style_dim, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))

    def forward(
        self, x: torch.Tensor, style: torch.Tensor, skip: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        out = self.conv(x, style) + self.bias.to(x.dtype)
        if skip is not None:
            out = out + self.upsample(skip)
        return out


class ConvLayer(nn.Sequential):
    """Discriminator conv layer: [Blur + stride 2 if downsample] EqualConv2d
    [FusedLeakyReLU if activate]. The conv carries a bias only when it is not
    activated (the activation holds it)."""

    def __init__(
        self,
        in_channel: int,
        out_channel: int,
        kernel_size: int,
        downsample: bool = False,
        blur_kernel: Sequence[int] = DEFAULT_BLUR_KERNEL,
        bias: bool = True,
        activate: bool = True,
    ):
        layers: list[nn.Module] = []
        if downsample:
            p = (len(blur_kernel) - 2) + (kernel_size - 1)
            layers.append(Blur(blur_kernel, pad=((p + 1) // 2, p // 2)))
            stride, padding = 2, 0
        else:
            stride, padding = 1, kernel_size // 2
        layers.append(
            EqualConv2d(in_channel, out_channel, kernel_size, stride=stride, padding=padding,
                        bias=bias and not activate)
        )
        if activate:
            layers.append(FusedLeakyReLU(out_channel, bias=bias))
        super().__init__(*layers)


class ResBlock(nn.Module):
    """Discriminator residual block: two 3x3 ConvLayers (the second
    downsamples) plus a 1x1 downsampling skip, summed and scaled by 1/sqrt(2)."""

    def __init__(
        self, in_channel: int, out_channel: int, blur_kernel: Sequence[int] = DEFAULT_BLUR_KERNEL,
        use_skip: bool = True,
    ):
        super().__init__()
        self.conv1 = ConvLayer(in_channel, in_channel, 3)
        self.conv2 = ConvLayer(in_channel, out_channel, 3, downsample=True, blur_kernel=blur_kernel)
        if use_skip:
            self.skip = ConvLayer(in_channel, out_channel, 1, downsample=True, activate=False, bias=False)
        self.use_skip = use_skip

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        if self.use_skip:
            out = (out + self.skip(x)) / math.sqrt(2.0)
        return out


def minibatch_stddev(x: torch.Tensor, group_size: int = 4, num_features: int = 1, eps: float = 1e-8,
                     cross_rank: bool = False) -> torch.Tensor:
    """Append the cross-sample stddev feature map. Groups are taken along the
    outer axis (`reshape(group, -1, ...)`): group member g of statistic j is
    sample g * (B / group) + j, so an interleaved [f0, r0, f1, r1, ...] batch
    whose B / group is even keeps fakes and reals apart. The group clamps to
    the batch, and to the whole batch when it does not divide it. With
    `cross_rank` the batch is the data-parallel ranks' blocks gathered end to
    end (`parallel.gather_batch`), and each rank keeps its block's maps."""
    full = gather_batch(x) if cross_rank else x
    b, c, h, w = full.shape
    group = min(b, group_size)
    if b % group != 0:
        group = b
    y = full.reshape(group, -1, num_features, c // num_features, h, w)
    y = torch.sqrt(y.var(dim=0, correction=0) + eps)
    y = y.mean(dim=(2, 3, 4), keepdim=True).squeeze(2)  # [B / group, F, 1, 1]
    y = y.repeat(group, 1, h, w)
    return torch.cat([x, local_rows(y) if cross_rank else y], dim=1)

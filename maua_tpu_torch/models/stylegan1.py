"""StyleGAN1 inference (lernapparat architecture) in PyTorch (counterpart of
maua_tpu/models/stylegan1.py).

G_mapping: pixel norm + 8 equalized linears (lr multiplier 0.01) with
leaky-ReLU. G_synthesis: a learned 4x4 constant, then one block per
resolution of [2x up-conv (a transposed conv of the 4-tap summed weight from
64^2 up, nearest upscale + 3x3 conv below) -> [1, 2, 1] blur -> bias ->
epilogue -> 3x3 conv -> epilogue], each epilogue noise -> leaky-ReLU ->
instance norm -> style modulation `x * (s0 + 1) + s1`; a final 1x1 to RGB.
Truncation lerps the first 8 of the 18 latents toward the mean latent. Each
block's single noise map feeds both of its epilogues. The leaky-ReLU is a
plain one (the gain lives in the equalized weights), so no fused bias-act
kernel runs here.

The module tree carries the lernapparat G_style keys
(`g_mapping.dense3.weight`, `g_synthesis.blocks.64x64.conv0_up.weight`,
`g_synthesis.blocks.8x8.epi1.style_mod.lin.bias`, ...), so a G_style state
dict loads as it is (`StyleGAN1.from_state_dict`); the noise buffers are
`noises.noise_{i}`. Like the StyleGAN2 Generator, the forward takes render()'s
keyword arguments and returns (image, None). It runs in fp32 with TF32 off.

The up-conv's bias is added after the blur on both paths, as NVlabs'
G_synthesis (`layer_epilogue(blur(upscale2d_conv2d(x)))`, whose epilogue adds
the bias) and lernapparat's `MyConv2d` do. The JAX package departs from both:
its transposed-conv path adds no bias and its upscale path adds it before the
zero-padded blur, where the border pixels take 3/4 of it and the corners 9/16.
The blur is upfirdn2d (the hand-written kernel on a CUDA tensor), with its
taps held on the module's device.

Spans (`telemetry.phase`, device-timed, on only while a profiler records):
`sg1.synthesis` around the blocks and torgb, one a forward; `sg1.up` around
each block's up-conv, blur and bias; `sg1.epilogue` around each epilogue.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.upfirdn2d import setup_filter, upfirdn2d
from ..telemetry.profiling import phase
from .blocks import apply_bends, tf32

__all__ = ["StyleGAN1", "load_stylegan1", "nf"]

N_LATENT = 18
STYLE_DIM = 512


def nf(stage: int, fmap_base: int = 8192, fmap_max: int = 512) -> int:
    """Feature maps at `stage` (resolution 2^(stage + 1))."""
    return min(int(fmap_base / (2.0**stage)), fmap_max)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class _Linear(nn.Module):
    """Equalized linear: x @ (W * gain / sqrt(in) * lrmul)^T + b * lrmul."""

    def __init__(self, cin: int, cout: int, gain: float = math.sqrt(2), lrmul: float = 1.0):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.w_mul = gain * cin**-0.5 * lrmul
        self.lrmul = lrmul

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ (self.weight * self.w_mul).t() + self.bias * self.lrmul


class _Conv(nn.Module):
    """Equalized conv: weight [O, I, k, k] scaled by gain / sqrt(I k k), plus a bias."""

    def __init__(self, cin: int, cout: int, k: int, gain: float = math.sqrt(2)):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.w_mul = gain * (cin * k * k) ** -0.5

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        return F.conv2d(x, self.weight * self.w_mul, self.bias, padding=k // 2)


class _UpConv(_Conv):
    """G_synthesis' Conv0_up: 2x upscale + 3x3 conv, the [1, 2, 1] blur, then
    the bias. From a 128^2 output a stride-2 transposed conv of the 4-tap
    summed weight; below, nearest upscale and the conv."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3)
        self.register_buffer("blur", setup_filter([1, 2, 1]), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight * self.w_mul
        if min(x.shape[2:]) * 2 >= 128:
            w = F.pad(w.transpose(0, 1), (1, 1, 1, 1))  # [I, O, 5, 5]
            w = w[:, :, 1:, 1:] + w[:, :, :-1, 1:] + w[:, :, 1:, :-1] + w[:, :, :-1, :-1]  # [I, O, 4, 4]
            x = F.conv_transpose2d(x, w, stride=2, padding=1)
        else:
            x = F.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), w, padding=1)
        return upfirdn2d(x, self.blur, pad=(1, 1)) + self.bias.reshape(1, -1, 1, 1)


class _NoiseWeight(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(channels))


class _TopEpi(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.noise = _NoiseWeight(channels)


class _StyleMod(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.lin = _Linear(STYLE_DIM, 2 * channels, gain=1.0)


class _Epilogue(nn.Module):
    """noise -> leaky-ReLU -> instance norm (population variance, eps 1e-5)
    -> x * (s0 + 1) + s1."""

    def __init__(self, channels: int):
        super().__init__()
        self.top_epi = _TopEpi(channels)
        self.style_mod = _StyleMod(channels)

    def forward(self, x: torch.Tensor, w: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        with phase("sg1.epilogue", device=x.device):
            x = _lrelu(x + self.top_epi.noise.weight.reshape(1, -1, 1, 1) * noise)
            mean = x.mean(dim=(2, 3), keepdim=True)
            var = x.var(dim=(2, 3), keepdim=True, correction=0)
            x = (x - mean) * torch.rsqrt(var + 1e-5)
            s = self.style_mod.lin(w).reshape(w.shape[0], 2, -1, 1, 1)
            return x * (s[:, 0] + 1.0) + s[:, 1]


class _Block(nn.Module):
    def __init__(self, cin: int, cout: int, first: bool, const_hw: tuple[int, int]):
        super().__init__()
        self.first = first
        if first:
            self.const = nn.Parameter(torch.zeros(1, cout, *const_hw))
            self.bias = nn.Parameter(torch.zeros(cout))
            self.conv = _Conv(cout, cout, 3)
        else:
            self.conv0_up = _UpConv(cin, cout)
            self.conv1 = _Conv(cout, cout, 3)
        self.epi1 = _Epilogue(cout)
        self.epi2 = _Epilogue(cout)

    def forward(self, x: Optional[torch.Tensor], w1: torch.Tensor, w2: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        if self.first:
            x = self.const.expand(w1.shape[0], -1, -1, -1) + self.bias.reshape(1, -1, 1, 1)
            x = self.epi1(x, w1, noise)
            return self.epi2(self.conv(x), w2, noise)
        with phase("sg1.up", device=x.device):
            x = self.conv0_up(x)
        x = self.epi1(x, w1, noise)
        return self.epi2(self.conv1(x), w2, noise)


class _Mapping(nn.Module):
    def __init__(self):
        super().__init__()
        for i in range(8):
            setattr(self, f"dense{i}", _Linear(STYLE_DIM, STYLE_DIM, lrmul=0.01))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = z * torch.rsqrt(z.square().mean(dim=1, keepdim=True) + 1e-8)
        for i in range(8):
            x = _lrelu(getattr(self, f"dense{i}")(x))
        return x


class _Synthesis(nn.Module):
    def __init__(self, channels: Sequence[int], const_hw: tuple[int, int]):
        super().__init__()
        self.blocks = nn.ModuleDict()
        for i, c in enumerate(channels):
            res = 4 * 2**i
            self.blocks[f"{res}x{res}"] = _Block(channels[i - 1] if i else c, c, i == 0, const_hw)
        self.torgb = _Conv(channels[-1], 3, 1, gain=1.0)


class StyleGAN1(nn.Module):
    """StyleGAN1 G_style: `channels[i]` feature maps at 4 * 2^i, a constant of
    `const_hw` (4x8 for a 1920-wide output). Parameters start at zero: build
    it from a state dict with `from_state_dict`."""

    def __init__(self, size: int, channels: Sequence[int], const_hw: tuple[int, int] = (4, 4)):
        super().__init__()
        self.size = size
        self.log_size = int(math.log2(size))
        self.n_latent = N_LATENT
        self.style_dim = STYLE_DIM
        self.num_layers = self.log_size - 1  # one noise map per block
        self.const_hw = tuple(const_hw)
        if len(channels) != self.num_layers:
            raise ValueError(f"{size}^2 needs {self.num_layers} block widths, got {len(channels)}")
        self.g_mapping = _Mapping()
        self.g_synthesis = _Synthesis(channels, self.const_hw)
        self.noises = nn.Module()
        ch, cw = self.const_hw
        for i in range(self.num_layers):
            self.noises.register_buffer(f"noise_{i}", torch.zeros(1, 1, ch * 2**i, cw * 2**i))

    @classmethod
    def from_state_dict(
        cls,
        state_dict: Mapping[str, Any],
        output_size: Optional[int] = None,
        noise_rng: Optional[torch.Generator] = None,
    ) -> "StyleGAN1":
        """A G_style state dict (numpy arrays or tensors) -> StyleGAN1 on the
        CPU. The resolution and widths come from the block keys. A 4x4
        constant is widened to 4x8 for output_size 1920 (edge columns
        repeated twice each side) and cropped to its centre 2x2 for 512 from
        a 1024 model. Noise buffers come from `noises.noise_{i}` when the
        state dict has them, else are drawn N(0, 1) from `noise_rng` (a CPU
        generator, default seed 0)."""
        sd = {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in state_dict.items()}
        res = sorted({int(k.split(".")[2].split("x")[0]) for k in sd if k.startswith("g_synthesis.blocks.")})
        size = res[-1]
        channels = [int(sd[f"g_synthesis.blocks.{r}x{r}.epi1.top_epi.noise.weight"].shape[0]) for r in res]
        const = sd["g_synthesis.blocks.4x4.const"]
        if const.shape[2:] == (4, 4):
            if output_size == 1920:
                const = torch.cat([const[..., :1], const[..., :1], const, const[..., -1:], const[..., -1:]], dim=3)
            elif output_size == 512 and size == 1024:
                const = const[:, :, 1:3, 1:3]
        sd["g_synthesis.blocks.4x4.const"] = const
        model = cls(size, channels, tuple(const.shape[2:]))
        own = model.state_dict()
        gen = noise_rng if noise_rng is not None else torch.Generator().manual_seed(0)
        for i in range(model.num_layers):
            name = f"noises.noise_{i}"
            if name not in sd:
                sd[name] = torch.randn(own[name].shape, generator=gen)
        missing = sorted(set(own) - set(sd))
        if missing:
            raise KeyError(f"not a StyleGAN1 (G_style) state dict: {len(missing)} keys missing, e.g. {missing[:3]}")
        model.load_state_dict({k: sd[k] for k in own}, strict=True)
        return model

    def _param_device(self) -> torch.device:
        return self.g_mapping.dense0.weight.device

    def get_latent(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, 512] -> w [B, 512]."""
        with tf32(conv=False, matmul=False):
            return self.g_mapping(z)

    def map_latents(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, 512] -> W+ [B, 18, 512]."""
        return self.get_latent(z)[:, None, :].repeat(1, self.n_latent, 1)

    @torch.no_grad()
    def mean_latent(self, rng: Optional[torch.Generator] = None, n_latent: int = 2**14) -> torch.Tensor:
        """Mean mapped latent [1, 512] of n_latent z drawn from `rng` (a
        torch.Generator on the module's device; None = the global one)."""
        z = torch.randn((n_latent, STYLE_DIM), generator=rng, device=self._param_device())
        return self.get_latent(z).mean(dim=0, keepdim=True)

    def forward(
        self,
        styles: torch.Tensor,
        input_is_latent: bool = True,
        noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
        randomize_noise: bool = False,
        truncation: Any = 1.0,
        truncation_latent: Optional[torch.Tensor] = None,
        bends: Sequence[Any] = (),
        map_latents: bool = False,
        rng: Optional[torch.Generator] = None,
        **_,
    ):
        """Images [B, 3, H, W] from W+ [B, 18, 512] (or w [B, 512], or z with
        input_is_latent=False). `noise` holds one map per block ([B or 1, 1,
        h, w] or None); a None takes the stored buffer unless
        randomize_noise, which draws one from `rng` per block. Returns
        (image, None); with map_latents, the W+ of z."""
        with tf32(conv=False, matmul=False):
            if map_latents:
                return self.map_latents(styles)
            latent = styles if input_is_latent else self.g_mapping(styles)
            if latent.ndim == 2:
                latent = latent[:, None, :].repeat(1, self.n_latent, 1)
            if truncation_latent is not None and not (isinstance(truncation, float) and truncation == 1.0):
                t = torch.as_tensor(truncation, dtype=latent.dtype, device=latent.device).reshape(-1, 1, 1)
                tl = truncation_latent.reshape(1, 1, -1).to(latent)
                first8 = (torch.arange(self.n_latent, device=latent.device) < 8)[None, :, None]
                latent = torch.where(first8, tl + t * (latent - tl), latent)

            nz = list(noise) if noise is not None else [None] * self.num_layers
            x = None
            with phase("sg1.synthesis", device=latent.device):
                for i, block in enumerate(self.g_synthesis.blocks.values()):
                    n = nz[i] if i < len(nz) else None
                    h, w = self.const_hw[0] * 2**i, self.const_hw[1] * 2**i
                    if n is None and randomize_noise:
                        n = torch.randn((latent.shape[0], 1, h, w), generator=rng, device=latent.device)
                    elif n is None and not randomize_noise and i < len(nz):
                        n = getattr(self.noises, f"noise_{i}")
                    elif n is None:
                        n = torch.zeros((1, 1, h, w), device=latent.device)
                    x = block(x, latent[:, 2 * i], latent[:, 2 * i + 1], n.to(latent))
                    x = apply_bends(x, i, bends)
                return self.g_synthesis.torgb(x), None


def load_stylegan1(checkpoint: str, output_size: Optional[int] = None, device: DeviceLike = None) -> StyleGAN1:
    """A StyleGAN1 from a torch G_style checkpoint (a flat state dict, or one
    under `g_ema`) on `device` (default `cuda`; RuntimeError without a card),
    in eval mode with no gradient on its weights."""
    device = resolve_device(device)
    ckpt = torch.load(checkpoint, map_location="cpu", weights_only=False)
    sd = ckpt.get("g_ema", ckpt) if isinstance(ckpt, dict) else ckpt
    if not any(k.startswith("g_synthesis") for k in sd):
        raise ValueError("not a StyleGAN1 (G_style) checkpoint")
    return StyleGAN1.from_state_dict(sd, output_size=output_size).requires_grad_(False).to(device).eval()

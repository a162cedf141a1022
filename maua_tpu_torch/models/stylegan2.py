"""StyleGAN2 Generator and Discriminator in PyTorch (counterpart of
maua_tpu/models/stylegan2.py:47-403).

Mapping MLP, constant or latent-mapped input (`--noconst`), style mixing with
`inject_index`, scalar or per-sample tensor truncation, per-layer noise
(stored buffers, explicit timelines, or drawn from a `torch.Generator`),
`min_rgb_size`, activation maps, network-bend hooks at every layer, and the
noise-buffer geometry of widescreen outputs. The module tree carries the
rosinality state-dict keys (`style.1.weight`, `convs.3.conv.weight`,
`to_rgbs.0.bias`, `noises.noise_0`, ...; the Discriminator's `convs.0.0.weight`,
`convs.1.conv1.0.weight`, `final_linear.1.bias`, ...).
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch
from torch import nn

from .blocks import (
    DEFAULT_BLUR_KERNEL,
    ConstantInput,
    ConvLayer,
    EqualLinear,
    LatentInput,
    PixelNorm,
    ResBlock,
    StyledConv,
    ToRGB,
    apply_bends,
    minibatch_stddev,
    tf32,
)


def channel_map(channel_multiplier: int = 2, channel_max: int = 512) -> dict[int, int]:
    """Channels per resolution, capped at `channel_max`."""
    table = {
        4: 512,
        8: 512,
        16: 512,
        32: 512,
        64: 256 * channel_multiplier,
        128: 128 * channel_multiplier,
        256: 64 * channel_multiplier,
        512: 32 * channel_multiplier,
        1024: 16 * channel_multiplier,
    }
    return {k: min(v, channel_max) for k, v in table.items()}


def noise_shapes(
    size: int, output_size: Optional[int] = None, base_res_factor: float = 1
) -> list[tuple[int, int, int, int]]:
    """Shapes of the per-layer noise buffers, with the widescreen rule:
    1920 doubles the width, 1080 the height, and base_res_factor scales both."""
    log_size = int(math.log2(size))
    shapes = []
    for layer_idx in range((log_size - 2) * 2 + 1):
        res = (layer_idx + 5) // 2
        if output_size is not None and (output_size != size or base_res_factor != 1):
            h = int(base_res_factor * 2**res * (2 if output_size == 1080 else 1))
            w = int(base_res_factor * 2**res * (2 if output_size == 1920 else 1))
        else:
            h = w = 2**res
        shapes.append((1, 1, h, w))
    return shapes


class MappingNetwork(nn.Sequential):
    """PixelNorm + n_mlp equalized linears with fused leaky-ReLU, lr_mul 0.01
    (children 0..n_mlp, as the rosinality `style` Sequential)."""

    def __init__(self, style_dim: int = 512, n_mlp: int = 8, lr_mlp: float = 0.01):
        layers = [PixelNorm()]
        layers += [
            EqualLinear(style_dim, style_dim, lr_mul=lr_mlp, activation="fused_lrelu")
            for _ in range(n_mlp)
        ]
        super().__init__(*layers)


class Generator(nn.Module):
    """StyleGAN2 mapping + synthesis.

    `dtype` is the synthesis dtype (float32 or bfloat16); the mapping network,
    truncation and demodulation stay fp32 and the image comes back fp32.
    `precision` is "exact" or "fast" (see models/blocks.py). Parameters stay
    fp32 whatever the dtype; move the module with `.to(device)`.
    """

    def __init__(
        self,
        size: int = 1024,
        style_dim: int = 512,
        n_mlp: int = 8,
        channel_multiplier: int = 2,
        blur_kernel: Sequence[int] = DEFAULT_BLUR_KERNEL,
        lr_mlp: float = 0.01,
        constant_input: bool = False,
        min_rgb_size: int = 4,
        output_size: Optional[int] = None,
        base_res_factor: float = 1,
        channel_max: int = 512,
        dtype: torch.dtype = torch.float32,
        precision: str = "exact",
    ):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        self.size = size
        self.style_dim = style_dim
        self.n_mlp = n_mlp
        self.constant_input = constant_input
        self.min_rgb_size = min_rgb_size
        self.output_size = output_size
        self.base_res_factor = base_res_factor
        self.dtype = dtype
        self.precision = precision
        self.log_size = int(math.log2(size))
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.n_latent = self.log_size * 2 - 2

        channels = channel_map(channel_multiplier, channel_max)
        self.style = MappingNetwork(style_dim, n_mlp, lr_mlp)
        if constant_input:
            self.input = ConstantInput(channels[4])
        else:
            self.input = LatentInput(style_dim, channels[4])
        self.conv1 = StyledConv(
            channels[4], channels[4], 3, style_dim, blur_kernel=blur_kernel, layer_id=1, precision=precision
        )
        self.to_rgb1 = ToRGB(channels[4], style_dim, upsample=False)

        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        in_channel = channels[4]
        layer_id = 1
        for i in range(3, self.log_size + 1):
            out_channel = channels[2**i]
            for upsample in (True, False):
                layer_id += 1
                self.convs.append(
                    StyledConv(
                        in_channel, out_channel, 3, style_dim, upsample=upsample,
                        blur_kernel=blur_kernel, layer_id=layer_id, precision=precision,
                    )
                )
                in_channel = out_channel
            self.to_rgbs.append(ToRGB(out_channel, style_dim, blur_kernel=blur_kernel))

        self.noises = nn.Module()
        for i, shape in enumerate(noise_shapes(size, output_size, base_res_factor)):
            self.noises.register_buffer(f"noise_{i}", torch.zeros(shape))

    def _param_device(self) -> torch.device:
        return self.style[1].weight.device

    def get_latent(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, style_dim] -> w [B, style_dim]."""
        with tf32(conv=False, matmul=False):
            return self.style(z)

    def map_latents(self, z: torch.Tensor) -> torch.Tensor:
        """z [B, style_dim] -> W+ [B, n_latent, style_dim]."""
        return self.get_latent(z)[:, None, :].repeat(1, self.n_latent, 1)

    @torch.no_grad()
    def mean_latent(self, rng: Optional[torch.Generator] = None, n_latent: int = 2**14) -> torch.Tensor:
        """Mean mapped latent [1, style_dim] of n_latent z drawn from `rng`
        (a torch.Generator on the module's device; None = the global one)."""
        z = torch.randn((n_latent, self.style_dim), generator=rng, device=self._param_device())
        return self.get_latent(z).mean(dim=0, keepdim=True)

    def forward(
        self,
        styles: torch.Tensor | Sequence[torch.Tensor],
        return_latents: bool = False,
        return_activation_maps: bool = False,
        inject_index: Optional[int] = None,
        truncation: Any = 1.0,
        truncation_latent: Optional[torch.Tensor] = None,
        input_is_latent: bool = False,
        noise: Optional[Sequence[Optional[torch.Tensor]]] = None,
        randomize_noise: bool = True,
        bends: Sequence[Any] = (),
        map_latents: bool = False,
        rng: Optional[torch.Generator] = None,
    ):
        """Synthesize images [B, 3, H, W] (fp32).

        Returns (image, None), (image, activation_maps) or (image, W+ latents).
        `truncation` is a float or a per-sample [B] tensor; any value other
        than 1 needs `truncation_latent`. `noise` entries that are None take the
        stored buffers when `randomize_noise` is False and are drawn from `rng`
        otherwise. `bends` is a list of (layer_id, fn) pairs."""
        with tf32(conv=False, matmul=False):
            if map_latents:
                return self.map_latents(styles if isinstance(styles, torch.Tensor) else styles[0])
            return self._forward(
                styles, return_latents, return_activation_maps, inject_index, truncation,
                truncation_latent, input_is_latent, noise, randomize_noise, bends, rng,
            )

    def _forward(
        self, styles, return_latents, return_activation_maps, inject_index, truncation,
        truncation_latent, input_is_latent, noise, randomize_noise, bends, rng,
    ):
        # --- W+ assembly and style mixing ---
        if not input_is_latent:
            styles = [styles] if isinstance(styles, torch.Tensor) else list(styles)
            ws = [self.style(s) for s in styles]
            if len(ws) < 2:
                latent = ws[0] if ws[0].ndim >= 3 else ws[0][:, None, :].repeat(1, self.n_latent, 1)
            else:
                idx = inject_index if inject_index is not None else self.n_latent // 2
                latent = torch.cat(
                    [
                        ws[0][:, None, :].repeat(1, idx, 1),
                        ws[1][:, None, :].repeat(1, self.n_latent - idx, 1),
                    ],
                    dim=1,
                )
        else:
            latent = styles if isinstance(styles, torch.Tensor) else styles[0]
            if latent.ndim == 2:
                latent = latent[:, None, :].repeat(1, self.n_latent, 1)

        # --- noise defaults ---
        noise = list(noise) if noise is not None else []
        noise += [None] * (self.num_layers - len(noise))
        if not randomize_noise:
            noise = [getattr(self.noises, f"noise_{i}") if n is None else n for i, n in enumerate(noise)]

        # --- truncation: per-sample lerp towards truncation_latent ---
        if truncation_latent is None:
            # a scalar is checked by value; a per-sample vector signals intent
            scalar = isinstance(truncation, (int, float)) or getattr(truncation, "ndim", 1) == 0
            if not scalar or float(truncation) != 1.0:
                raise ValueError(
                    "truncation != 1 (or tensor truncation) requires truncation_latent "
                    "(precompute it with Generator.mean_latent)"
                )
        else:
            tl = truncation_latent.reshape(1, 1, -1).to(latent)
            t = torch.as_tensor(truncation, dtype=latent.dtype, device=latent.device)
            t = t.reshape(-1).expand(latent.shape[0])[:, None, None]
            latent = tl + t * (latent - tl)

        # --- synthesis in self.dtype ---
        out = self.input(latent.shape[0]) if self.constant_input else self.input(latent)
        out = out.to(self.dtype)
        latent_fp32 = latent
        latent = latent.to(self.dtype)
        noise = [None if n is None else n.to(self.dtype) for n in noise]
        out = apply_bends(out, 0, bends)
        out = self.conv1(out, latent[:, 0], noise[0], bends, rng)
        activation_maps = [out]

        current_size = 4
        image = self.to_rgb1(out, latent[:, 1]) if self.min_rgb_size <= current_size else None
        i = 1
        for k, to_rgb in enumerate(self.to_rgbs):
            out = self.convs[2 * k](out, latent[:, i], noise[2 * k + 1], bends, rng)
            current_size *= 2
            activation_maps.append(out)
            out = self.convs[2 * k + 1](out, latent[:, i + 1], noise[2 * k + 2], bends, rng)
            activation_maps.append(out)
            if self.min_rgb_size <= current_size:
                image = to_rgb(out, latent[:, i + 2], image)
            i += 2

        image = image.float()
        if return_activation_maps:
            return image, activation_maps
        if return_latents:
            return image, latent_fp32.float()
        return image, None


class Discriminator(nn.Module):
    """StyleGAN2 residual discriminator: from_rgb (`convs.0`), one ResBlock per
    resolution down to 4x4 (`convs.1` ...), minibatch stddev, `final_conv`
    and the two `final_linear` layers.

    `dtype` is the conv compute dtype (float32 or bfloat16); the stddev
    statistic and the final linears run in fp32 and the logits come back
    fp32. Parameters stay fp32. The forward holds TF32 off (exact fp32)."""

    def __init__(
        self,
        size: int = 1024,
        channel_multiplier: int = 2,
        blur_kernel: Sequence[int] = DEFAULT_BLUR_KERNEL,
        use_skip: bool = True,
        stddev_group: int = 4,
        stddev_feat: int = 1,
        channel_max: int = 512,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        channels = channel_map(channel_multiplier, channel_max)
        log_size = int(math.log2(size))
        self.size = size
        self.dtype = dtype
        self.stddev_group = stddev_group
        self.stddev_feat = stddev_feat
        blocks: list[nn.Module] = [ConvLayer(3, channels[size], 1)]
        in_channel = channels[size]
        for i in range(log_size, 2, -1):
            out_channel = channels[2 ** (i - 1)]
            blocks.append(ResBlock(in_channel, out_channel, blur_kernel, use_skip=use_skip))
            in_channel = out_channel
        self.convs = nn.Sequential(*blocks)
        self.final_conv = ConvLayer(in_channel + stddev_feat, channels[4], 3)
        self.final_linear = nn.Sequential(
            EqualLinear(channels[4] * 4 * 4, channels[4], activation="fused_lrelu"),
            EqualLinear(channels[4], 1),
        )

    def forward(self, x: torch.Tensor, return_hidden: bool = False):
        """x [B, 3, size, size] -> logits [B, 1] (fp32); with `return_hidden`
        also the last ResBlock's activation (in the compute dtype)."""
        with tf32(conv=False, matmul=False):
            hidden = self.convs(x.to(self.dtype))
            batch = hidden.shape[0]
            # the statistic in fp32: the variance of near-equal values cancels in bf16
            out = minibatch_stddev(hidden.float(), self.stddev_group, self.stddev_feat).to(self.dtype)
            out = self.final_conv(out).reshape(batch, -1).float()
            out = self.final_linear(out)
        return (out, hidden) if return_hidden else out

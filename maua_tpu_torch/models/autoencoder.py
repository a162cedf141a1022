"""The autoencoder / VAE family (counterpart of maua_tpu/models/autoencoder.py;
the reference's models/autoencoder.py): `LogCoshVAE` (log-cosh
reconstruction + KLD), `ConvSegNet` / `VariationalConvSegNet` (VGG-style conv
autoencoders) and `InceptionVAE` (1/3/5/7-kernel inception blocks), with
`vae_loss` (MSE + KLD) for the last three.

Torch modules need their widths up front, so each model takes the input
resolution `size` that flax reads from the first batch. Parameters and
running statistics follow the JAX package:

* `ConvBN` is conv (no bias) -> batch norm -> activation. `act="fused_lrelu"`
  (LogCoshVAE) runs `ops.fused_act.fused_leaky_relu` with its own bias, so on
  a CUDA tensor the forward and gradient kernels of csrc/fused_bias_act.cu do
  the activation.
* `BatchNorm` is flax's, not `nn.BatchNorm2d`: in training mode it normalises
  with the biased batch variance E[x^2] - E[x]^2 (clipped at 0) and updates
  the running mean and variance as 0.9 * running + 0.1 * batch, the biased
  variance included; in eval mode it uses the running statistics.
* Weights are drawn like flax's `lecun_normal` (a normal truncated at two
  standard deviations, variance 1 / fan_in with flax's fan-in of the OIHW
  shape: k * O * I for a conv, the input width for a linear layer), biases
  and batch-norm shifts 0, batch-norm scales 1.
* The reparameterisation z = mu + exp(log_var / 2) * eps takes `eps`
  [B, model.code_dim] from the caller, or draws it from `generator`, so a
  test can hand both packages the same draw.
* `_upsample2x` is `F.interpolate` bilinear with half-pixel centres
  (jax.image.resize's 2x upsample, which equals it: an upsample does not
  antialias) and `_maxpool2` `F.max_pool2d`.

`LogCoshVAE` decodes from 2x2 through `len(hidden_dims)` upsamples whatever
the input size, so its output is 2**(len(hidden_dims) + 1) square; only that
input size can be trained (`loss` raises ValueError otherwise), as in the
JAX package, whose loss fails to broadcast there.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_act import fused_leaky_relu

__all__ = [
    "BatchNorm",
    "ConvBN",
    "ConvSegNet",
    "InceptionVAE",
    "LogCoshVAE",
    "VariationalConvSegNet",
    "lecun_normal_",
    "vae_loss",
]

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def lecun_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's lecun_normal: a normal truncated at +-2 std, variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


def _linear(n_in: int, n_out: int) -> nn.Linear:
    lin = nn.Linear(n_in, n_out)
    lecun_normal_(lin.weight, n_in)
    nn.init.zeros_(lin.bias)
    return lin


def _conv_weight(out_ch: int, in_ch: int, k: int) -> nn.Parameter:
    return nn.Parameter(lecun_normal_(torch.empty(out_ch, in_ch, k, k), k * out_ch * in_ch))


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def _maxpool2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm over axis 1 (momentum 0.9, epsilon 1e-5)."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            dims = [0] + list(range(2, x.ndim))
            mean = x.mean(dim=dims)
            var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


class ConvBN(nn.Module):
    """conv + batch norm + activation ("relu" | "fused_lrelu" | "none")."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, stride: int = 1, act: str = "relu"):
        super().__init__()
        if act not in ("relu", "fused_lrelu", "none"):
            raise ValueError(f"unknown act {act!r}")
        self.stride, self.pad, self.act = stride, (kernel - 1) // 2, act
        self.weight = _conv_weight(features, in_ch, kernel)
        self.bn = BatchNorm(features)
        if act == "fused_lrelu":
            self.act_bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn(F.conv2d(x, self.weight, stride=self.stride, padding=self.pad))
        if self.act == "relu":
            return F.relu(out)
        if self.act == "fused_lrelu":
            return fused_leaky_relu(out, self.act_bias)
        return out


def _reparameterize(mu, log_var, eps, generator):
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
    return mu + torch.exp(0.5 * log_var) * eps


def _kld(mu: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    return torch.mean(-0.5 * torch.sum(1 + log_var - mu**2 - torch.exp(log_var), dim=1))


def _check_shapes(real: torch.Tensor, fake: torch.Tensor, hint: str = "") -> None:
    if real.shape != fake.shape:
        raise ValueError(f"the reconstruction {tuple(fake.shape)} does not match the input {tuple(real.shape)}{hint}")


class LogCoshVAE(nn.Module):
    """reference: models/autoencoder.py:41-141."""

    def __init__(self, size: int = 64, in_channels: int = 3, latent_dim: int = 512,
                 hidden_dims: Sequence[int] = (32, 64, 128, 256, 512), alpha: float = 10.0, beta: float = 1.0,
                 kld_weight: float = 1.0):
        super().__init__()
        hidden_dims = tuple(hidden_dims)
        self.latent_dim = self.code_dim = latent_dim
        self.hidden_dims = hidden_dims
        self.alpha, self.beta, self.kld_weight = alpha, beta, kld_weight
        chans = (in_channels,) + hidden_dims
        self.enc = nn.ModuleList(ConvBN(chans[i], hd, 3, stride=2, act="fused_lrelu") for i, hd in enumerate(hidden_dims))
        spatial = size
        for _ in hidden_dims:
            spatial = (spatial - 1) // 2 + 1  # a 3x3 conv with stride 2 and padding 1
        flat = hidden_dims[-1] * spatial * spatial
        self.fc_mu, self.fc_var = _linear(flat, latent_dim), _linear(flat, latent_dim)
        self.decoder_input = _linear(latent_dim, hidden_dims[-1] * 4)
        rev = list(reversed(hidden_dims))
        self.dec = nn.ModuleList(ConvBN(rev[i], rev[i + 1], 3, act="fused_lrelu") for i in range(len(rev) - 1))
        self.final = ConvBN(rev[-1], rev[-1], 3, act="fused_lrelu")
        self.final_weight = _conv_weight(3, rev[-1], 3)

    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        h = x
        for block in self.enc:
            h = block(h)
        flat = h.reshape(h.shape[0], -1)
        return self.fc_mu(flat), self.fc_var(flat)

    def forward(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """x [B, C, H, W] -> (recon [B, 3, 2**(n+1), 2**(n+1)] in (-1, 1), mu, log_var)."""
        mu, log_var = self.encode(x)
        z = _reparameterize(mu, log_var, eps, generator)
        # the Dense's own width, not latent_dim (the reference's reshape breaks
        # whenever they differ)
        d = self.decoder_input(z).reshape(-1, self.hidden_dims[-1], 2, 2)
        for block in self.dec:
            d = block(_upsample2x(d))
        d = self.final(_upsample2x(d))
        return torch.tanh(F.conv2d(d, self.final_weight, padding=1)), mu, log_var

    def loss(self, real: torch.Tensor, fake: torch.Tensor, mu: torch.Tensor, log_var: torch.Tensor) -> dict:
        """log-cosh reconstruction + KLD (reference: autoencoder.py:130-141)."""
        _check_shapes(real, fake, ": LogCoshVAE decodes to 2**(len(hidden_dims) + 1) square whatever the input "
                      "size, so it trains only at that size (vae_cli: --size 2**(n_layers + 1))")
        t = fake - real
        rec = self.alpha * t + torch.log1p(torch.exp(-2 * self.alpha * t)) - math.log(2.0)
        rec = torch.mean(rec) / self.alpha
        kld = _kld(mu, log_var)
        return {"Total": rec + self.beta * self.kld_weight * kld, "Reconstruction": rec,
                "Kullback Leibler Divergence": -kld}


_SEG_ENC = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]


def _seg_dec_chans(in_channels: int) -> list[tuple[int, ...]]:
    return [(512, 512, 512), (512, 512, 256), (256, 256, 128), (128, 64), (64, in_channels)]


class _SegNetBody(nn.Module):
    """The SegNet encoder (conv-BN-relu blocks, each ending in a 2x2 max pool,
    then tanh) and decoder (2x upsample + conv-BN-relu blocks)."""

    def __init__(self, in_channels: int, width_mult: float):
        super().__init__()
        self.width_mult = width_mult
        enc, ch = [], in_channels
        for width, n in _SEG_ENC:
            block = []
            for _ in range(n):
                block.append(ConvBN(ch, self._w(width), 3))
                ch = self._w(width)
            enc.append(nn.ModuleList(block))
        self.enc = nn.ModuleList(enc)
        self.enc_channels = ch
        dec_chans = _seg_dec_chans(in_channels)
        dec = []
        for bi, chs in enumerate(dec_chans):
            block = []
            for ci, width in enumerate(chs):
                out = width if (bi == len(dec_chans) - 1 and ci == len(chs) - 1) else self._w(width)
                block.append(ConvBN(ch, out, 3))
                ch = out
            dec.append(nn.ModuleList(block))
        self.dec = nn.ModuleList(dec)

    def _w(self, ch: int) -> int:
        return max(4, int(ch * self.width_mult))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.enc:
            for layer in block:
                x = layer(x)
            x = _maxpool2(x)
        return torch.tanh(x)

    def decode(self, h: torch.Tensor) -> torch.Tensor:
        for block in self.dec:
            h = _upsample2x(h)
            for layer in block:
                h = layer(h)
        return h


class ConvSegNet(_SegNetBody):
    """VGG-ish conv autoencoder (reference: autoencoder.py:337-398); width_mult
    scales the hidden widths (1.0 = the reference's)."""

    def __init__(self, in_channels: int = 3, width_mult: float = 1.0):
        super().__init__(in_channels, width_mult)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))


class VariationalConvSegNet(_SegNetBody):
    """reference: autoencoder.py:401-480: the SegNet encoder, fc mu / log_var
    over the flattened code, the decoder and a tanh."""

    def __init__(self, size: int = 128, in_channels: int = 3, width_mult: float = 1.0):
        super().__init__(in_channels, width_mult)
        self.spatial = size // 2 ** len(_SEG_ENC)
        dim = self.code_dim = self.enc_channels * self.spatial**2
        self.fc_mu, self.fc_var = _linear(dim, dim), _linear(dim, dim)

    def forward(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        h = self.encode(x)
        flat = h.reshape(h.shape[0], -1)
        mu, log_var = self.fc_mu(flat), self.fc_var(flat)
        z = _reparameterize(mu, log_var, eps, generator)
        h = z.reshape(-1, self.enc_channels, self.spatial, self.spatial)
        return torch.tanh(self.decode(h)), mu, log_var


class _IncBlock(nn.Module):
    """Parallel 1/3/5/7-kernel conv-BN-relu, concatenated (reference
    EncoderInceptionModuleSignle, autoencoder.py:490-511)."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.k1, self.k3, self.k5, self.k7 = (ConvBN(in_ch, features // 4, k) for k in (1, 3, 5, 7))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.k1(x), self.k3(x), self.k5(x), self.k7(x)], dim=1)


class InceptionVAE(nn.Module):
    """reference: autoencoder.py:639+: an inception-block encoder and decoder VAE."""

    def __init__(self, size: int = 64, in_channels: int = 3, latent_dim: int = 512, base: int = 64, n_down: int = 4):
        super().__init__()
        self.code_dim = latent_dim
        self.stem = ConvBN(in_channels, base, 3)
        enc, ch = [], base
        for i in range(n_down):
            width = base * 2 ** min(i, 3)
            enc.append(_IncBlock(ch, width))
            ch = 4 * (width // 4)
        self.enc = nn.ModuleList(enc)
        self.enc_channels, self.spatial = ch, size // 2**n_down
        flat = ch * self.spatial**2
        self.fc_mu, self.fc_var = _linear(flat, latent_dim), _linear(flat, latent_dim)
        self.fc_dec = _linear(latent_dim, flat)
        dec = []
        for i in range(n_down):
            width = base * 2 ** max(n_down - 2 - i, 0)
            dec.append(_IncBlock(ch, width))
            ch = 4 * (width // 4)
        self.dec = nn.ModuleList(dec)
        self.out_weight = _conv_weight(in_channels, ch, 3)

    def forward(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        h = self.stem(x)
        for block in self.enc:
            h = _maxpool2(block(h))
        flat = h.reshape(h.shape[0], -1)
        mu, log_var = self.fc_mu(flat), self.fc_var(flat)
        z = _reparameterize(mu, log_var, eps, generator)
        h = self.fc_dec(z).reshape(-1, self.enc_channels, self.spatial, self.spatial)
        for block in self.dec:
            h = block(_upsample2x(h))
        return torch.tanh(F.conv2d(h, self.out_weight, padding=1)), mu, log_var


def vae_loss(real: torch.Tensor, fake: torch.Tensor, mu: torch.Tensor, log_var: torch.Tensor,
             kld_weight: float = 1.0) -> dict:
    """Plain MSE + KLD loss for the SegNet / Inception VAEs."""
    _check_shapes(real, fake)
    rec = torch.mean(torch.square(fake - real))
    kld = _kld(mu, log_var)
    return {"Total": rec + kld_weight * kld, "Reconstruction": rec, "Kullback Leibler Divergence": -kld}

"""The lucidrains alternative StyleGAN2 in PyTorch (counterpart of
maua_tpu/models/lucidrains.py).

A self-contained variant with its own blocks: `StyleVectorizer` (a plain
leaky-ReLU MLP), `GeneratorBlock` with per-pixel learned noise projections
and bilinear upsampling, `RGBBlock` accumulation, `Conv2DMod`, residual
discriminator blocks, optional linear attention (a Rezero residual) and
feature quantization (`VectorQuantize`) in D, the hinge losses, the gradient
penalty and per-sample style mixing.

Module and parameter names are the JAX package's flax names (`block_3`,
`to_noise1`, `conv_2_0`, `attn_1_0`, `fq_0`, `rezero_g`, `codebook`,
`initial_block`, ...), so `io.jax_params.lucidrains_state_dict_from_jax`
carries the JAX params across by name. Layouts are PyTorch's: a flax Dense
kernel [in, out] is an `nn.Linear` weight [out, in], a flax Conv kernel HWIO
an `nn.Conv2d` weight OIHW; `Conv2DMod.weight` is OIHW in both. Maps are NCHW
to the logit. Every activation is a plain leaky ReLU (slope 0.2): this family
runs no kernel of the repo. The forwards hold TF32 off (exact fp32), as the
StyleGAN2 models do.

`Conv2DMod` scales the input by the style, runs one conv with the shared
weight and scales the output by the demodulation factor, as the JAX package
does, instead of the reference's per-sample weights under `groups=batch`.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_bilinear
from .blocks import tf32

EPS = 1e-8

__all__ = [
    "Conv2DMod",
    "GeneratorBlock",
    "LinearAttention",
    "LucidrainsDiscriminator",
    "LucidrainsGenerator",
    "RGBBlock",
    "StyleDraw",
    "StyleVectorizer",
    "VectorQuantize",
    "draw_styles",
    "gradient_penalty",
    "hinge_d_loss",
    "hinge_g_loss",
    "mixed_styles",
]


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, 2H, 2W] with `jax.image.resize`'s bilinear weights."""
    return resize_bilinear(x, (2 * x.shape[2], 2 * x.shape[3]))


def _trunc_normal_(t: torch.Tensor, std: float) -> torch.Tensor:
    """flax's truncated normal: N(0, 1) cut at +-2, scaled so that its std is `std`."""
    with torch.no_grad():
        nn.init.trunc_normal_(t, std=1.0, a=-2.0, b=2.0)
        return t.mul_(std / 0.87962566103423978)


def _dense(in_dim: int, out_dim: int, bias: bool = True) -> nn.Linear:
    """flax `nn.Dense`'s initialisation: lecun normal kernel, zero bias."""
    m = nn.Linear(in_dim, out_dim, bias=bias)
    _trunc_normal_(m.weight, math.sqrt(1.0 / in_dim))
    if bias:
        nn.init.zeros_(m.bias)
    return m


def _conv(in_chan: int, out_chan: int, kernel: int, stride: int = 1, padding: int = 0, bias: bool = True) -> nn.Conv2d:
    """flax `nn.Conv`'s initialisation: lecun normal kernel, zero bias."""
    m = nn.Conv2d(in_chan, out_chan, kernel, stride=stride, padding=padding, bias=bias)
    _trunc_normal_(m.weight, math.sqrt(1.0 / (in_chan * kernel * kernel)))
    if bias:
        nn.init.zeros_(m.bias)
    return m


class Conv2DMod(nn.Module):
    """Modulated conv: the weight times (style + 1), optionally demodulated.
    style: [B, in_chan]."""

    def __init__(self, in_chan: int, out_chan: int, kernel: int = 3, demod: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_chan, in_chan, kernel, kernel))
        # flax's variance_scaling(2 / (1 + 0.2^2), "fan_in", "normal")
        with torch.no_grad():
            self.weight.normal_(0.0, math.sqrt(2.0 / (1 + 0.2**2) / (in_chan * kernel * kernel)))
        self.kernel = kernel
        self.demod = demod

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        s = style + 1.0
        if self.demod:
            w_sq = self.weight.square().sum(dim=(2, 3))  # [O, I]
            demod = torch.rsqrt(s.square() @ w_sq.t() + EPS)  # [B, O]
        x = x * s[:, :, None, None].to(x.dtype)
        out = F.conv2d(x, self.weight.to(x.dtype), padding=(self.kernel - 1) // 2)
        if self.demod:
            out = out * demod[:, :, None, None].to(out.dtype)
        return out


class StyleVectorizer(nn.Module):
    """depth x (linear + leaky ReLU); z [B, emb] -> w [B, emb]."""

    def __init__(self, emb: int = 512, depth: int = 8):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"dense_{i}", _dense(emb, emb))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = z
        with tf32(conv=False, matmul=False):
            for i in range(self.depth):
                x = _lrelu(getattr(self, f"dense_{i}")(x))
        return x


class LinearAttention(nn.Module):
    """Image linear attention in a Rezero residual: softmax of q over the key
    dim (after the d^-0.5 scale), softmax of k over the pixels, two
    contractions, O(N d^2). `rezero_g` starts at 0."""

    def __init__(self, chan: int, key_dim: int = 64, heads: int = 8):
        super().__init__()
        inner = heads * key_dim
        self.to_q = _conv(chan, inner, 1, bias=False)
        self.to_k = _conv(chan, inner, 1, bias=False)
        self.to_v = _conv(chan, inner, 1, bias=False)
        self.to_out = _conv(inner, chan, 1)
        self.rezero_g = nn.Parameter(torch.zeros(()))
        self.key_dim = key_dim
        self.heads = heads

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        d = self.key_dim

        def heads(t):  # [B, heads * d, H, W] -> [B, heads, HW, d]
            return t.reshape(b, self.heads, d, h * w).transpose(-1, -2)

        q, k, v = heads(self.to_q(x)), heads(self.to_k(x)), heads(self.to_v(x))
        q = torch.softmax(q * d**-0.5, dim=-1)
        k = torch.softmax(k, dim=-2)
        ctx = torch.einsum("bhnd,bhne->bhde", k, v)
        out = torch.einsum("bhnd,bhde->bhne", q, ctx)
        out = self.to_out(out.transpose(-1, -2).reshape(b, self.heads * d, h, w))
        return x + (self.rezero_g * out).to(x.dtype)


class VectorQuantize(nn.Module):
    """Per-pixel quantisation of the channel vector to the nearest of
    `codebook_size` codes, with the straight-through estimator; returns
    (out [B, C, H, W], codebook loss + commitment x commitment loss)."""

    def __init__(self, dim: int, codebook_size: int = 256, commitment: float = 0.25):
        super().__init__()
        self.codebook = nn.Parameter(torch.randn(codebook_size, dim))
        self.dim = dim
        self.commitment = commitment

    def nearest(self, flat: torch.Tensor) -> torch.Tensor:
        """Index of the nearest code of each row of flat [N, dim]."""
        cb = self.codebook
        d = flat.square().sum(1, keepdim=True) - 2 * flat @ cb.t() + cb.square().sum(1)[None]
        return torch.argmin(d, dim=1)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        b, _, h, w = x.shape
        flat = x.permute(0, 2, 3, 1).reshape(-1, self.dim)
        quant = self.codebook[self.nearest(flat)]
        commit_loss = (quant.detach() - flat).square().mean()
        codebook_loss = (quant - flat.detach()).square().mean()
        loss = codebook_loss + self.commitment * commit_loss
        quant = flat + (quant - flat).detach()  # straight-through
        return quant.reshape(b, h, w, self.dim).permute(0, 3, 1, 2), loss


class RGBBlock(nn.Module):
    def __init__(self, latent_dim: int, input_channels: int, upsample: bool, rgba: bool = False):
        super().__init__()
        self.to_style = _dense(latent_dim, input_channels)
        self.conv = Conv2DMod(input_channels, 4 if rgba else 3, 1, demod=False)
        self.upsample = upsample

    def forward(self, x: torch.Tensor, prev_rgb: Optional[torch.Tensor], istyle: torch.Tensor) -> torch.Tensor:
        x = self.conv(x, self.to_style(istyle))
        if prev_rgb is not None:
            x = x + prev_rgb
        if self.upsample:
            x = _upsample2x_bilinear(x)
        return x


class GeneratorBlock(nn.Module):
    """[upsample] -> Conv2DMod + noise -> lrelu, twice -> RGBBlock. The noise
    projection maps the crop [B, H, W, 1] to [B, H, W, F] and takes it as
    [B, F, W, H] (the JAX package's and the reference's transpose(0, 3, 2, 1)),
    which swaps the noise's H and W."""

    def __init__(self, latent_dim: int, input_channels: int, filters: int, upsample: bool = True,
                 upsample_rgb: bool = True, rgba: bool = False):
        super().__init__()
        self.to_noise1 = _dense(1, filters)
        self.to_noise2 = _dense(1, filters)
        self.to_style1 = _dense(latent_dim, input_channels)
        self.conv1 = Conv2DMod(input_channels, filters, 3)
        self.to_style2 = _dense(latent_dim, filters)
        self.conv2 = Conv2DMod(filters, filters, 3)
        self.to_rgb = RGBBlock(latent_dim, filters, upsample_rgb, rgba)
        self.upsample = upsample

    def forward(self, x, prev_rgb, istyle, inoise):
        if self.upsample:
            x = _upsample2x_bilinear(x)
        h, w = x.shape[2], x.shape[3]
        crop = inoise[:, :h, :w, :]  # [B, H, W, 1]
        noise1 = self.to_noise1(crop).permute(0, 3, 2, 1)
        noise2 = self.to_noise2(crop).permute(0, 3, 2, 1)
        x = _lrelu(self.conv1(x, self.to_style1(istyle)) + noise1)
        x = _lrelu(self.conv2(x, self.to_style2(istyle)) + noise2)
        return x, self.to_rgb(x, prev_rgb, istyle)


class LucidrainsGenerator(nn.Module):
    """styles [B, num_layers, latent_dim], input_noise [B, S, S, 1] -> RGB(A)
    [B, 3 or 4, S, S]."""

    def __init__(self, image_size: int = 128, latent_dim: int = 512, network_capacity: int = 16,
                 transparent: bool = False, attn_layers: Sequence[int] = ()):
        super().__init__()
        self.image_size = image_size
        self.latent_dim = latent_dim
        self.num_layers = int(math.log2(image_size) - 1)
        n = self.num_layers
        init_channels = 4 * network_capacity
        filters = [init_channels] + [network_capacity * (2 ** (i + 1)) for i in range(n)][::-1]
        self.initial_block = nn.Parameter(torch.randn(init_channels, 4, 4))
        self.attn = []
        for ind in range(n):
            in_chan, out_chan = filters[ind], filters[ind + 1]
            if n - ind in attn_layers:
                self.add_module(f"attn_{ind}_0", LinearAttention(in_chan))
                self.add_module(f"attn_{ind}_1", LinearAttention(in_chan))
                self.attn.append(ind)
            self.add_module(f"block_{ind}", GeneratorBlock(latent_dim, in_chan, out_chan, upsample=ind != 0,
                                                           upsample_rgb=ind != n - 1, rgba=transparent))

    def forward(self, styles: torch.Tensor, input_noise: torch.Tensor) -> torch.Tensor:
        x = self.initial_block[None].expand(styles.shape[0], -1, -1, -1)
        rgb = None
        with tf32(conv=False, matmul=False):
            for ind in range(self.num_layers):
                if ind in self.attn:
                    x = getattr(self, f"attn_{ind}_1")(getattr(self, f"attn_{ind}_0")(x))
                x, rgb = getattr(self, f"block_{ind}")(x, rgb, styles[:, ind], input_noise)
        return rgb


class LucidrainsDiscriminator(nn.Module):
    """x [B, 3 or 4, S, S] -> (logits [B], quantize loss): residual blocks
    (1x1 `res`, two 3x3 `conv`s, a stride-2 `down` but for the last), linear
    attention and vector quantisation after the blocks they name, and a
    linear logit of the NCHW map flattened."""

    def __init__(self, image_size: int = 128, network_capacity: int = 16, fq_layers: Sequence[int] = (),
                 fq_dict_size: int = 256, attn_layers: Sequence[int] = (), transparent: bool = False):
        super().__init__()
        n = int(math.log2(image_size) - 1)
        filters = [4 if transparent else 3] + [network_capacity * (2**i) for i in range(n + 1)]
        self.n_blocks = len(filters) - 1
        self.attn, self.fq = [], []
        size = image_size
        for ind in range(self.n_blocks):
            in_chan, out_chan = filters[ind], filters[ind + 1]
            self.add_module(f"res_{ind}", _conv(in_chan, out_chan, 1))
            self.add_module(f"conv_{ind}_0", _conv(in_chan, out_chan, 3, padding=1))
            self.add_module(f"conv_{ind}_1", _conv(out_chan, out_chan, 3, padding=1))
            if ind != self.n_blocks - 1:
                self.add_module(f"down_{ind}", _conv(out_chan, out_chan, 3, stride=2, padding=1))
                size = (size - 1) // 2 + 1
            if ind + 1 in attn_layers:
                self.add_module(f"attn_{ind}_0", LinearAttention(out_chan))
                self.add_module(f"attn_{ind}_1", LinearAttention(out_chan))
                self.attn.append(ind)
            if ind + 1 in fq_layers:
                self.add_module(f"fq_{ind}", VectorQuantize(out_chan, fq_dict_size))
                self.fq.append(ind)
        self.to_logit = _dense(filters[-1] * size * size, 1)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        q_loss = x.new_zeros(())
        with tf32(conv=False, matmul=False):
            for ind in range(self.n_blocks):
                res = getattr(self, f"res_{ind}")(x)
                h = _lrelu(getattr(self, f"conv_{ind}_0")(x))
                h = _lrelu(getattr(self, f"conv_{ind}_1")(h))
                x = h + res
                if ind != self.n_blocks - 1:
                    x = getattr(self, f"down_{ind}")(x)
                if ind in self.attn:
                    x = getattr(self, f"attn_{ind}_1")(getattr(self, f"attn_{ind}_0")(x))
                if ind in self.fq:
                    x, loss = getattr(self, f"fq_{ind}")(x)
                    q_loss = q_loss + loss
            logit = self.to_logit(x.reshape(x.shape[0], -1))
        return logit.squeeze(-1), q_loss


# ---------------------------------------------------------------- losses


def hinge_d_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    """relu(1 + real).mean() + relu(1 - fake).mean(): the reference's sign
    convention, which trains D to push real logits negative."""
    return F.relu(1.0 + real_logits).mean() + F.relu(1.0 - fake_logits).mean()


def hinge_g_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    return fake_logits.mean()


def gradient_penalty(d_apply, images: torch.Tensor, weight: float = 10.0) -> torch.Tensor:
    """weight * mean over samples of |d sum(D(x)) / dx|^2 on real images,
    differentiable (a double backward through D). `d_apply(x)` returns
    (logits, quantize loss), as the discriminator does."""
    x = images.detach().requires_grad_(True)
    out, _ = d_apply(x)
    (g,) = torch.autograd.grad(out.sum(), x, create_graph=True)
    return weight * g.reshape(g.shape[0], -1).square().sum(dim=1).mean()


class StyleDraw(NamedTuple):
    """The draws of one `mixed_styles`: z1, z2 [B, latent_dim] N(0, 1); mix
    [B] bool (mix with probability mixing_prob); tt [B] int64, the first
    layer of w2, uniform on [1, num_layers)."""

    z1: torch.Tensor
    z2: torch.Tensor
    mix: torch.Tensor
    tt: torch.Tensor


def draw_styles(source: Any, batch: int, num_layers: int, latent_dim: int, mixing_prob: float = 0.9,
                device: Any = None) -> StyleDraw:
    """A StyleDraw from a torch.Generator (on `device`) or from a `Draws`-like
    object (`normal(*shape)`, `uniform(*shape)`; tt = 1 + floor(u *
    (num_layers - 1)))."""
    if isinstance(source, torch.Generator):
        dev = source.device if device is None else torch.device(device)
        z1 = torch.randn((batch, latent_dim), generator=source, device=dev)
        z2 = torch.randn((batch, latent_dim), generator=source, device=dev)
        mix = torch.rand((batch,), generator=source, device=dev) < mixing_prob
        tt = torch.randint(1, num_layers, (batch,), generator=source, device=dev)
        return StyleDraw(z1, z2, mix, tt)
    z1, z2 = source.normal(batch, latent_dim), source.normal(batch, latent_dim)
    mix = source.uniform(batch) < mixing_prob
    tt = 1 + torch.floor(source.uniform(batch) * (num_layers - 1)).long().clamp_(max=num_layers - 2)
    return StyleDraw(z1, z2, mix, tt)


def mixed_styles(draws: Union[StyleDraw, torch.Generator, Any], vectorizer_apply, batch: int, num_layers: int,
                 latent_dim: int, mixing_prob: float = 0.9) -> torch.Tensor:
    """W per layer [B, num_layers, latent_dim] with per-sample mixing: the
    layers from tt on take w2 where mix, all layers w1 elsewhere. `draws` is
    a StyleDraw, or a source for `draw_styles`."""
    if not isinstance(draws, StyleDraw):
        draws = draw_styles(draws, batch, num_layers, latent_dim, mixing_prob)
    w1, w2 = vectorizer_apply(draws.z1), vectorizer_apply(draws.z2)
    tt = torch.where(draws.mix, draws.tt, torch.full_like(draws.tt, num_layers))
    layer_idx = torch.arange(num_layers, device=w1.device)[None, :, None]
    return torch.where(layer_idx >= tt[:, None, None], w2[:, None], w1[:, None])

"""LPIPS perceptual distance (counterpart of maua_tpu/eval/lpips.py).

ImageNet-normalised input -> VGG16 or AlexNet feature stacks (cuDNN convs)
-> unit-normalised per channel -> linear 1x1 heads clamped to >= 0 -> spatial
mean -> sum over layers. The backbone is an `nn.Sequential` named `features`
with torchvision's layer indices, and the heads are `lin{i}.model.1.weight`
[1, C, 1, 1], so a torchvision `vgg16` / `alexnet` state dict's `features.*`
and the richzhang LPIPS `.pth` heads load as they are (`LPIPS.load`).

`LPIPS.precision` is "exact" (TF32 off in cuDNN, the default) or "fast"
(TF32 on); the distance is fp32 either way.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..models.blocks import tf32

__all__ = ["LPIPS", "make_perceptual_loss", "perceptual_lpips"]

# imagenet shift / scale in [-1, 1] space
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
VGG_CHANNELS = [64, 128, 256, 512, 512]
ALEX_SPECS = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1)]  # (out, k, stride, pad)
ALEX_CHANNELS = [64, 192, 384, 256, 256]


def _vgg16_features() -> tuple[nn.Sequential, list[int]]:
    """torchvision's vgg16().features up to relu5_3, and the indices after
    which relu1_2 .. relu5_3 are taken. Max pools are 2x2 / 2, VALID."""
    layers: list[nn.Module] = []
    taps = []
    cin = 3
    for i, v in enumerate(VGG16_CFG):
        if v == "M":
            layers.append(nn.MaxPool2d(2, 2))
            continue
        layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU()]
        cin = v
        if i + 1 == len(VGG16_CFG) or VGG16_CFG[i + 1] == "M":
            taps.append(len(layers) - 1)
    return nn.Sequential(*layers), taps


def _alex_features() -> tuple[nn.Sequential, list[int]]:
    """torchvision's alexnet().features without its last pool; every ReLU
    is a tap, and 3x3 / 2 VALID max pools follow the first two."""
    layers: list[nn.Module] = []
    taps = []
    cin = 3
    for i, (out, k, s, p) in enumerate(ALEX_SPECS):
        layers += [nn.Conv2d(cin, out, k, stride=s, padding=p), nn.ReLU()]
        taps.append(len(layers) - 1)
        if i in (0, 1):
            layers.append(nn.MaxPool2d(3, 2))
        cin = out
    return nn.Sequential(*layers), taps


class _LinHead(nn.Module):
    """richzhang `NetLinLayer`: `model.1` is the 1x1 conv [1, C, 1, 1] (no
    bias); `model.0`, its dropout, holds no weight and is the identity here."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))
        nn.init.ones_(self.model[1].weight)


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """x / (||x||_C + eps); the tiny inner epsilon keeps sqrt differentiable at 0."""
    norm = torch.sqrt(x.square().sum(dim=1, keepdim=True) + 1e-20)
    return x / (norm + eps)


def lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """flax's lecun_normal: a normal truncated at +-2 of its sigma, with
    variance 1 / fan_in after the truncation."""
    std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)


class LPIPS(nn.Module):
    """lpips(x, y) for x, y in [-1, 1] NCHW -> [N] distances.

    The backbone is drawn from `seed` (flax's lecun_normal, zero biases) and
    the heads are ones until `load` replaces them."""

    def __init__(self, net: str = "vgg", seed: int = 0, precision: str = "exact"):
        super().__init__()
        if net not in ("vgg", "alex"):
            raise ValueError(f"net must be 'vgg' or 'alex', got {net!r}")
        self.net = net
        self.precision = precision
        self.features, self.taps = _vgg16_features() if net == "vgg" else _alex_features()
        channels = VGG_CHANNELS if net == "vgg" else ALEX_CHANNELS
        for i, c in enumerate(channels):
            setattr(self, f"lin{i}", _LinHead(c))
        gen = torch.Generator().manual_seed(seed)
        for m in self.features:
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, gen)
                nn.init.zeros_(m.bias)
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1), persistent=False)

    def load(self, backbone_sd: Optional[Mapping[str, Any]] = None, lin_sd: Optional[Mapping[str, Any]] = None) -> "LPIPS":
        """Load a torchvision backbone state dict (its `features.*` keys; the
        classifier is ignored) and / or richzhang heads (`lin{i}.model.1.weight`).
        What is not given stays as it is."""
        own = self.state_dict()
        sd = {}
        for src, prefix in ((backbone_sd, "features."), (lin_sd, "lin")):
            for k, v in (src or {}).items():
                if k.startswith(prefix) and k in own:
                    sd[k] = torch.as_tensor(np.asarray(v, np.float32)).reshape(own[k].shape)
        self.load_state_dict(sd, strict=False)
        return self

    def stacks(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        x = (x - self.shift) / self.scale
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.taps:
                feats.append(x)
        return feats

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fast = self.precision == "fast"
        with tf32(conv=fast, matmul=fast):
            fx, fy = self.stacks(x.float()), self.stacks(y.float())
        total = torch.zeros(x.shape[0], device=x.device)
        for i, (a, b) in enumerate(zip(fx, fy)):
            d = (_unit_normalize(a) - _unit_normalize(b)).square()  # [N, C, H, W]
            lin = torch.clamp(getattr(self, f"lin{i}").model[1].weight.reshape(1, -1, 1, 1), min=0.0)
            total = total + (d * lin).sum(dim=1).mean(dim=(1, 2))
        return total


def perceptual_lpips(backbone_sd=None, net: str = "vgg", device: DeviceLike = None, precision: str = "exact") -> LPIPS:
    """An LPIPS with the backbone loaded from `backbone_sd` (random from seed
    0 when None) and the heads at their initial ones, in eval mode with no
    gradient on its weights, on `device` (default `cuda`)."""
    lp = LPIPS(net=net, precision=precision).load(backbone_sd, None)
    return lp.requires_grad_(False).eval().to(resolve_device(device))


def make_perceptual_loss(backbone_sd=None, net: str = "vgg", image_size: int = 64, device: DeviceLike = None,
                         precision: str = "exact"):
    """loss(a, b) -> the mean over pairs of `perceptual_lpips`'s distance
    (counterpart of maua_tpu/train/vae.py:26-44). `image_size` is the JAX
    signature's, where flax initialises from an example input; a torch
    module needs none."""
    lp = perceptual_lpips(backbone_sd, net, device, precision)

    def loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return lp(a, b).mean()

    return loss

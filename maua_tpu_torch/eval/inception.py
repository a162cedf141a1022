"""InceptionV3 pool3 feature extractor, the FID backbone (counterpart of
maua_tpu/eval/inception.py).

The module tree carries torchvision's and pytorch-fid's key names
(`Conv2d_1a_3x3.conv.weight`, `Mixed_5b.branch1x1.bn.running_var`, ...), so
either state dict loads as it is (`InceptionV3.load`; `AuxLogits.*` and `fc.*`
are ignored). Each BasicConv2d is a bias-free conv, batch norm with its
stored statistics (eps 1e-3) and ReLU.

`fid_variant=False` (the default) is torchvision's network: 3x3 / 1 average
pools that divide by 9 (`count_include_pad=True`) and an average pool in
Mixed_7c. `fid_variant=True` is pytorch-fid's FIDInception, for its
`pt_inception` weights: the A, C and E blocks' average pools exclude the
padding from the count and Mixed_7c's pool branch is a 3x3 / 1 / 1 max pool.

Input: [-1, 1] NCHW at 299^2 (`preprocess` resizes). `precision` is "exact"
(TF32 off, the default) or "fast" (TF32 on).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.blocks import tf32
from ..ops.resize import resize_bilinear
from .lpips import lecun_normal_

__all__ = ["InceptionV3"]


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # inference batch norm as JAX writes it: x * inv + (bias - mean * inv)
        inv = self.bn.weight * torch.rsqrt(self.bn.running_var + self.bn.eps)
        shift = self.bn.bias - self.bn.running_mean * inv
        return F.relu(self.conv(x) * inv[None, :, None, None] + shift[None, :, None, None])


def _avgpool(x: torch.Tensor, count_include_pad: bool) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=count_include_pad)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, fid_variant: bool):
        super().__init__()
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avgpool(x, not self.fid_variant))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, fid_variant: bool):
        super().__init__()
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for layer in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        bp = self.branch_pool(_avgpool(x, not self.fid_variant))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for layer in (self.branch7x7x3_2, self.branch7x7x3_3, self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, max_pool: bool, fid_variant: bool):
        super().__init__()
        self.max_pool = max_pool
        self.fid_variant = fid_variant
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        pooled = F.max_pool2d(x, 3, 1, 1) if self.max_pool else _avgpool(x, not self.fid_variant)
        return torch.cat([b1, b3, bd, self.branch_pool(pooled)], dim=1)


class InceptionV3(nn.Module):
    """pool3 (2048-d) features of [-1, 1] NCHW images at 299^2.

    The weights are drawn from `seed` as flax initialises the JAX network
    (lecun_normal convs, identity batch norms) until `load` replaces them."""

    def __init__(self, fid_variant: bool = False, seed: int = 0, precision: str = "exact"):
        super().__init__()
        fid = self.fid_variant = fid_variant
        self.precision = precision
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, fid)
        self.Mixed_5c = InceptionA(256, 64, fid)
        self.Mixed_5d = InceptionA(288, 64, fid)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fid)
        self.Mixed_6c = InceptionC(768, 160, fid)
        self.Mixed_6d = InceptionC(768, 160, fid)
        self.Mixed_6e = InceptionC(768, 192, fid)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, False, fid)
        self.Mixed_7c = InceptionE(2048, fid, fid)
        gen = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, gen)

    def load(self, state_dict: Mapping[str, Any]) -> "InceptionV3":
        """Load a torchvision or pytorch-fid InceptionV3 state dict (strict
        over this network's keys; its extra heads are ignored)."""
        own = self.state_dict()
        sd = {k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items() if k in own}
        missing = sorted(set(own) - set(sd) - {k for k in own if k.endswith("num_batches_tracked")})
        if missing:
            raise KeyError(f"InceptionV3.load: {len(missing)} keys missing, e.g. {missing[:3]}")
        self.load_state_dict(sd, strict=False)
        return self

    @staticmethod
    def preprocess(img: torch.Tensor) -> torch.Tensor:
        """[-1, 1] NCHW of any size -> 299^2, bilinear (antialiased when it shrinks)."""
        return resize_bilinear(img, (299, 299))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fast = self.precision == "fast"
        with tf32(conv=fast, matmul=fast):
            x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x.float())))
            x = F.max_pool2d(x, 3, 2)
            x = F.max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, 2)
            for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d",
                         "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
                x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # adaptive average pool -> [N, 2048]

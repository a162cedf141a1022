"""upfirdn2d — upsample, FIR-filter, downsample — in plain PyTorch.

Same semantics as maua_tpu/ops/upfirdn2d.py:45-170 and its numpy oracle:

  1. zero-stuff:  insert (up-1) zeros after every sample along H and W
  2. pad:         pad0 before / pad1 after on each spatial dim (negative crops)
  3. convolve:    true 2-D convolution (correlation with the flipped kernel),
                  one kernel shared over N and C
  4. downsample:  keep every `down`-th sample

  out_size = (in_size * up + pad0 + pad1 - kernel_size) // down + 1

Steps 3 and 4 are one depthwise `F.conv2d` with stride `down`.

The gradient is an autograd Function whose backward is upfirdn2d again (the
flipped kernel, up and down swapped, the padding that maps the output grid
back onto the input), so it can be differentiated to any order and the
kernel, a fixed FIR filter, never gets a gradient. Left to autograd, the
double backward of the depthwise conv (R1 through D, the path penalty
through G) also computes the filter's gradient with one convolution per
channel, whether or not anything needs it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["setup_filter", "upfirdn2d"]


def setup_filter(f, normalize: bool = True, gain: float = 1.0) -> torch.Tensor:
    """2-D FIR filter from a 1-D tap list (outer product) or a 2-D array,
    normalised to unit sum and scaled by `gain` (fp32)."""
    f = torch.as_tensor(f, dtype=torch.float32)
    if f.ndim == 1:
        f = torch.outer(f, f)
    if f.ndim != 2:
        raise ValueError(f"filter must be 1-D or 2-D, got ndim={f.ndim}")
    if normalize:
        f = f / f.sum()
    return f * gain


def _as_pair(v) -> tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[0])) if len(v) == 1 else (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _as_pad(pad) -> tuple[int, int, int, int]:
    """(pad0, pad1) for both axes, or (pad_x0, pad_x1, pad_y0, pad_y1)."""
    if isinstance(pad, (tuple, list)):
        if len(pad) == 2:
            return (int(pad[0]), int(pad[1]), int(pad[0]), int(pad[1]))
        if len(pad) == 4:
            return tuple(int(p) for p in pad)  # type: ignore[return-value]
        raise ValueError(f"pad must have 2 or 4 elements, got {len(pad)}")
    return (int(pad),) * 4


def upfirdn2d(x: torch.Tensor, kernel: torch.Tensor, up=1, down=1, pad=(0, 0)) -> torch.Tensor:
    """x: [N, C, H, W]; kernel: [kh, kw]; up/down: int or (y, x); pad as in
    `_as_pad`. Returns [N, C, (H*up_y + pad_y0 + pad_y1 - kh)//down_y + 1, ...]."""
    if x.ndim != 4:
        raise ValueError(f"expected [N, C, H, W] input, got shape {tuple(x.shape)}")
    return _Upfirdn2d.apply(x, kernel.detach(), _as_pair(up), _as_pair(down), _as_pad(pad))


class _Upfirdn2d(torch.autograd.Function):
    """dx = upfirdn2d(dy, flipped kernel, up=down, down=up, pad=p), with p
    the padding that places the output grid back on the input grid."""

    @staticmethod
    def forward(ctx, x, kernel, up, down, pad):
        ctx.save_for_backward(kernel)
        ctx.geometry = (x.shape[2:], up, down, pad)
        return _upfirdn2d(x, kernel, up, down, pad)

    @staticmethod
    def backward(ctx, dy):
        (kernel,) = ctx.saved_tensors
        (h, w), (up_y, up_x), (down_y, down_x), (pad_x0, _, pad_y0, _) = ctx.geometry
        kh, kw = kernel.shape
        oh, ow = dy.shape[2:]
        pad = (
            kw - pad_x0 - 1, w * up_x - ow * down_x + pad_x0 - up_x + 1,
            kh - pad_y0 - 1, h * up_y - oh * down_y + pad_y0 - up_y + 1,
        )
        dx = _Upfirdn2d.apply(dy, torch.flip(kernel, (0, 1)), (down_y, down_x), (up_y, up_x), pad)
        return dx, None, None, None, None


def _upfirdn2d(x, kernel, up, down, pad):
    (up_y, up_x), (down_y, down_x) = up, down
    pad_x0, pad_x1, pad_y0, pad_y1 = pad
    n, c, h, w = x.shape
    kh, kw = kernel.shape

    if up_y > 1 or up_x > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, [0, up_x - 1, 0, 0, 0, up_y - 1])
        x = x.reshape(n, c, h * up_y, w * up_x)
    x = F.pad(x, [pad_x0, pad_x1, pad_y0, pad_y1])  # negative values crop
    k = torch.flip(kernel, (0, 1)).to(device=x.device, dtype=x.dtype)
    k = k[None, None].expand(c, 1, kh, kw).contiguous()
    return F.conv2d(x, k, stride=(down_y, down_x), groups=c)

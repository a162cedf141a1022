"""upfirdn2d — upsample, FIR-filter, downsample.

Same semantics as maua_tpu/ops/upfirdn2d.py:45-170 and its numpy oracle:

  1. zero-stuff:  insert (up-1) zeros after every sample along H and W
  2. pad:         pad0 before / pad1 after on each spatial dim (negative crops)
  3. convolve:    true 2-D convolution (correlation with the flipped kernel),
                  one kernel shared over N and C
  4. downsample:  keep every `down`-th sample

  out_size = (in_size * up + pad0 + pad1 - kernel_size) // down + 1

It has two forms:

* the CUDA kernel of csrc/upfirdn2d.cu, launched by `upfirdn2d_kernel`
  (counted in `launches`): all four steps in one pass, with no padded or
  zero-stuffed copy, for the geometries that `kernel_geometry` accepts;
* the plain PyTorch form `upfirdn2d_plain`: a padded (and zero-stuffed) copy,
  then one depthwise `F.conv2d` with stride `down`, for CPU tensors.

A CPU tensor takes the plain form, a CUDA tensor the kernel, and nothing
falls back from one to the other.

The gradient is an autograd Function whose backward is upfirdn2d again (the
flipped kernel, up and down swapped, the padding that maps the output grid
back onto the input), so it can be differentiated to any order and the
kernel, a fixed FIR filter, never gets a gradient. The flip is a flag, done
by index, so the backward makes no copy of the taps. Left to autograd, the
double backward of the depthwise conv (R1 through D, the path penalty
through G) also computes the filter's gradient with one convolution per
channel, whether or not anything needs it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

__all__ = [
    "backward_geometry",
    "kernel_geometry",
    "launches",
    "setup_filter",
    "upfirdn2d",
    "upfirdn2d_kernel",
    "upfirdn2d_plain",
]

KERNEL_MAX_TAPS = 12  # ADA's SYM6 filter, which always resamples
KERNEL_PLAIN_TAPS = 4  # without resampling: the models' [1, 3, 3, 1]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1

launches = 0  # kernel launches made by upfirdn2d_kernel in this process


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
    return _Upfirdn2d.apply(x, kernel.detach(), _as_pair(up), _as_pair(down), _as_pad(pad), False)


def backward_geometry(in_hw, k_hw, up, down, pad, out_hw):
    """(up, down, pad) of the upfirdn2d that carries dy [out_hw] back onto
    the input grid [in_hw] through the flipped kernel."""
    (h, w), (kh, kw), (up_y, up_x), (down_y, down_x) = in_hw, k_hw, up, down
    pad_x0, _, pad_y0, _ = pad
    oh, ow = out_hw
    bpad = (
        kw - pad_x0 - 1, w * up_x - ow * down_x + pad_x0 - up_x + 1,
        kh - pad_y0 - 1, h * up_y - oh * down_y + pad_y0 - up_y + 1,
    )
    return (down_y, down_x), (up_y, up_x), bpad


def kernel_geometry(shape, k_shape, up, down, pad) -> tuple[int, int]:
    """(out_h, out_w) if the CUDA kernel takes this geometry; ValueError if not.

    shape: the input's [N, C, H, W]; k_shape: [kh, kw]; up, down: (y, x);
    pad: (pad_x0, pad_x1, pad_y0, pad_y1). The kernel takes the same up and
    the same down on both axes, each 1 or 2 and not both 2, filters of 1 to
    4 taps a side (1 to 12 when up or down is 2), and any padding that leaves
    a non-empty output."""
    if len(shape) != 4:
        raise ValueError(f"upfirdn2d kernel: expected [N, C, H, W] input, got shape {tuple(shape)}")
    if len(k_shape) != 2 or not all(1 <= k <= KERNEL_MAX_TAPS for k in k_shape):
        raise ValueError(f"upfirdn2d kernel: takes a [kh, kw] filter of 1-{KERNEL_MAX_TAPS} taps a side, "
                         f"got {tuple(k_shape)}")
    (up_y, up_x), (down_y, down_x) = up, down
    if up_y != up_x or down_y != down_x or up_y not in (1, 2) or down_y not in (1, 2) or up_y == down_y == 2:
        raise ValueError(f"upfirdn2d kernel: takes up and down of 1 or 2, the same on both axes and not both 2, "
                         f"got up={tuple(up)} down={tuple(down)}")
    if up_y == down_y == 1 and max(k_shape) > KERNEL_PLAIN_TAPS:
        raise ValueError(f"upfirdn2d kernel: takes more than {KERNEL_PLAIN_TAPS} taps a side only with up or "
                         f"down 2, got a {tuple(k_shape)} filter")
    _, c, h, w = shape
    (kh, kw), (pad_x0, pad_x1, pad_y0, pad_y1) = k_shape, pad
    oh, ow = (h * up_y + pad_y0 + pad_y1 - kh) // down_y + 1, (w * up_x + pad_x0 + pad_x1 - kw) // down_x + 1
    if min(h, w) < 1 or min(oh, ow) < 1:
        raise ValueError(f"upfirdn2d kernel: empty plane: input {h}x{w}, output {oh}x{ow} (pad {tuple(pad)})")
    if max(h, w, oh, ow, *(abs(p) for p in pad)) > 2**20 or c > _INT32_MAX:
        raise ValueError(f"upfirdn2d kernel: plane {h}x{w} -> {oh}x{ow}, pad {tuple(pad)} or C={c} out of range")
    return oh, ow


def upfirdn2d_plain(x, kernel, up=(1, 1), down=(1, 1), pad=(0, 0, 0, 0), flip=False) -> torch.Tensor:
    """Plain PyTorch form: a zero-stuffed, padded copy, then one depthwise
    conv with stride `down`; the taps are cast to x's dtype. `flip` filters
    with the kernel flipped on both axes. Records a gradient through autograd."""
    (up_y, up_x), (down_y, down_x) = up, down
    pad_x0, pad_x1, pad_y0, pad_y1 = pad
    n, c, h, w = x.shape
    kh, kw = kernel.shape

    if up_y > 1 or up_x > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, [0, up_x - 1, 0, 0, 0, up_y - 1])
        x = x.reshape(n, c, h * up_y, w * up_x)
    x = F.pad(x, [pad_x0, pad_x1, pad_y0, pad_y1])  # negative values crop
    k = kernel if flip else torch.flip(kernel, (0, 1))  # correlation with the flipped kernel
    k = k.to(device=x.device, dtype=x.dtype)
    k = k[None, None].expand(c, 1, kh, kw).contiguous()
    return F.conv2d(x, k, stride=(down_y, down_x), groups=c)


def _dense_planes(x: torch.Tensor) -> bool:
    """Each [H, W] plane is dense and row-major (any strides for N and C)."""
    _, _, h, w = x.shape
    return (w == 1 or x.stride(3) == 1) and (h == 1 or x.stride(2) == w)


def upfirdn2d_kernel(x, kernel, up=(1, 1), down=(1, 1), pad=(0, 0, 0, 0), flip=False) -> torch.Tensor:
    """Launch the kernel. x: fp32 or bf16 CUDA tensor [N, C, H, W] whose
    planes are dense (N and C may be strided, as in a channel slice); kernel:
    fp32 [kh, kw] on x's device, read there (flipped by index with `flip`);
    up, down: (y, x); pad: (pad_x0, pad_x1, pad_y0, pad_y1). Returns a
    contiguous tensor in x's dtype. Records no gradient: `upfirdn2d` is the
    differentiable entry point. Non-finite inputs: an output's window also
    holds input samples that only a zero tap meets (the other phase's, or
    past a short filter's end), so an inf there gives NaN where the plain
    form gives inf or a finite value."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"upfirdn2d_kernel needs a CUDA tensor, got one on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"upfirdn2d_kernel takes float32 or bfloat16, got {x.dtype}")
    oh, ow = kernel_geometry(tuple(x.shape), tuple(kernel.shape), up, down, pad)
    if not _dense_planes(x):
        raise ValueError("upfirdn2d_kernel needs an input whose [H, W] planes are contiguous")
    if kernel.device != x.device or kernel.dtype != torch.float32 or not kernel.is_contiguous():
        raise ValueError(f"upfirdn2d_kernel needs contiguous float32 taps on {x.device}, "
                         f"got {kernel.dtype} on {kernel.device}")
    n, c, h, w = x.shape
    out = torch.empty((n, c, oh, ow), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    pad_x0, _, pad_y0, _ = pad
    fn = _build.library("upfirdn2d").upfirdn2d
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), kernel.data_ptr(), out.data_ptr(), n, c, x.stride(0), x.stride(1), h, w, oh, ow,
            up[0], down[0], pad_x0, pad_y0, kernel.shape[0], kernel.shape[1], int(flip), _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"upfirdn2d_kernel: CUDA error {err} at launch")
    launches += 1
    return out


def _upfirdn2d(x, kernel, up, down, pad, flip):
    """CPU tensor -> the plain form; CUDA tensor -> the kernel (or an error)."""
    if x.device.type == "cpu":
        return upfirdn2d_plain(x, kernel, up, down, pad, flip)
    return upfirdn2d_kernel(x if _dense_planes(x) else x.contiguous(), kernel.to(torch.float32), up, down, pad, flip)


class _Upfirdn2d(torch.autograd.Function):
    """dx = upfirdn2d(dy, flipped kernel, up=down, down=up, pad=p), with p
    the padding that places the output grid back on the input grid."""

    @staticmethod
    def forward(ctx, x, kernel, up, down, pad, flip):
        ctx.save_for_backward(kernel)
        ctx.geometry = (tuple(x.shape[2:]), up, down, pad, flip)
        return _upfirdn2d(x, kernel, up, down, pad, flip)

    @staticmethod
    def backward(ctx, dy):
        (kernel,) = ctx.saved_tensors
        in_hw, up, down, pad, flip = ctx.geometry
        b_up, b_down, b_pad = backward_geometry(in_hw, tuple(kernel.shape), up, down, pad, tuple(dy.shape[2:]))
        dx = _Upfirdn2d.apply(dy, kernel, b_up, b_down, b_pad, not flip)
        return dx, None, None, None, None, None

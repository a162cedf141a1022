"""Fused bias-add + scaled leaky-ReLU: `scale * leaky_relu(x + bias)`, with a
gradient that can be differentiated to any order.

Counterpart of maua_tpu/ops/fused_act.py:31-49 and of the Pallas kernels of
maua_tpu/ops/pallas_act.py (`_act_kernel` forward, `_grad_kernel` backward,
wired by the custom VJPs `_flr_bwd` and `_second_order_grad` / `_so_bwd`).

Each function has two forms:

* the CUDA kernels of csrc/fused_bias_act.cu, launched by `fused_bias_act`
  (forward; counted in `launches`) and `fused_bias_act_grad` (gradient;
  counted in `grad_launches`) on CUDA tensors;
* the plain PyTorch forms `fused_leaky_relu_plain` and
  `fused_bias_act_grad_plain`, the same arithmetic, for CPU tensors.

`fused_leaky_relu` is the entry point the models call. It runs through two
autograd Functions on every device, as the JAX package's custom VJPs do:

* `FusedBiasActFunction`: forward y = act(x + b), saving y; backward
  dx = `FusedBiasActGradFunction`(dy, y) and db = sum of dx over every axis
  but the channel axis (`torch.sum`, outside the kernel, in dx's dtype as
  JAX's `jnp.sum(dx)`, then cast to the bias's dtype);
* `FusedBiasActGradFunction`: forward dx = dy * gate(y), the gate taken from
  the sign of the saved output; backward, given ddx, the gate applied to ddx
  for dy and zero for y (the reference's second-order rule). R1 and the
  path-length penalty differentiate through it.

A CPU tensor takes the plain form, a CUDA tensor the kernel, and nothing falls
back from one to the other. The bias is broadcast on axis 1 for >= 3-D input
and on the last axis for 1-D / 2-D input.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

__all__ = [
    "FusedBiasActFunction",
    "FusedBiasActGradFunction",
    "fused_bias_act",
    "fused_bias_act_grad",
    "fused_bias_act_grad_plain",
    "fused_leaky_relu",
    "fused_leaky_relu_plain",
    "grad_launches",
    "launches",
]

SQRT2 = math.sqrt(2.0)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # forward kernel launches made by fused_bias_act in this process
grad_launches = 0  # gradient kernel launches made by fused_bias_act_grad in this process


def fused_leaky_relu_plain(
    x: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
    scale: float = SQRT2,
) -> torch.Tensor:
    """Plain PyTorch form; the bias is cast to x's dtype before the add."""
    if bias is not None:
        shape = (1, -1) + (1,) * (x.ndim - 2) if x.ndim >= 3 else (1,) * (x.ndim - 1) + (-1,)
        x = x + bias.reshape(shape).to(x.dtype)
    return torch.where(x >= 0, x, x * negative_slope) * scale


def fused_bias_act_grad_plain(
    dy: torch.Tensor, y: torch.Tensor, negative_slope: float = 0.2, scale: float = SQRT2
) -> torch.Tensor:
    """Plain PyTorch form of the gradient: dy * (y >= 0 ? 1 : slope) * scale,
    the gain in fp32 and one rounding to dy's dtype, as the kernel does."""
    gain = torch.where(y >= 0, 1.0, negative_slope) * scale  # fp32
    return (dy * gain).to(dy.dtype)


def _rows_cols(x: torch.Tensor) -> tuple[int, int, int]:
    """(rows, cols, channels) of the forward kernel's view: [N*C, prod(spatial)] for
    >= 3-D input, [prod(leading), C] for 1-D / 2-D input."""
    if x.ndim >= 3:
        return x.shape[0] * x.shape[1], math.prod(x.shape[2:]), x.shape[1]
    return x.numel() // x.shape[-1], x.shape[-1], x.shape[-1]


def _check_kernel_input(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got one on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous input")
    if x.ndim == 0:
        raise ValueError(f"{name} needs an input with at least one dimension")


def fused_bias_act(
    x: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
    scale: float = SQRT2,
) -> torch.Tensor:
    """Launch the forward kernel. x: contiguous fp32 or bf16 CUDA tensor;
    bias: [C] on the same device, read as fp32 (so bf16 input rounds once, on
    the store, where the plain form rounds the bias add too). Records no
    gradient: `fused_leaky_relu` is the differentiable entry point."""
    global launches
    _check_kernel_input("fused_bias_act", x)
    rows, cols, channels = _rows_cols(x)
    if bias is not None:
        if bias.ndim != 1 or bias.shape[0] != channels or bias.device != x.device:
            raise ValueError(
                f"bias must be [{channels}] on {x.device}, got {list(bias.shape)} on {bias.device}"
            )
        bias = bias.detach().to(torch.float32).contiguous()
    out = torch.empty_like(x, requires_grad=False)
    if x.numel() == 0:
        return out
    fn = _build.library("fused_bias_act").fused_bias_act
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            rows, cols, channels, 1 if x.ndim >= 3 else 0, _DTYPE_CODES[x.dtype],
            negative_slope, scale, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_bias_act: CUDA error {err} at launch")
    launches += 1
    return out


def fused_bias_act_grad(
    dy: torch.Tensor, y: torch.Tensor, negative_slope: float = 0.2, scale: float = SQRT2
) -> torch.Tensor:
    """Launch the gradient kernel: dx = dy * gate(y), elementwise over the
    flat tensors. dy and y: contiguous CUDA tensors of one shape and dtype
    (fp32 or bf16). Records no gradient: `FusedBiasActGradFunction` is the
    differentiable form."""
    global grad_launches
    _check_kernel_input("fused_bias_act_grad", dy)
    _check_kernel_input("fused_bias_act_grad", y)
    if dy.shape != y.shape or dy.dtype != y.dtype or dy.device != y.device:
        raise ValueError(
            f"fused_bias_act_grad: dy {dy.dtype} {list(dy.shape)} on {dy.device} and "
            f"y {y.dtype} {list(y.shape)} on {y.device} must agree"
        )
    out = torch.empty_like(dy, requires_grad=False)
    if dy.numel() == 0:
        return out
    fn = _build.library("fused_bias_act").fused_bias_act_grad
    with torch.cuda.device(dy.device):
        err = fn(
            dy.data_ptr(), y.data_ptr(), out.data_ptr(), dy.numel(), _DTYPE_CODES[dy.dtype],
            negative_slope, scale, torch.cuda.current_stream(dy.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_bias_act_grad: CUDA error {err} at launch")
    grad_launches += 1
    return out


class FusedBiasActGradFunction(torch.autograd.Function):
    """dx = dy * gate(y); d(dx)/d(dy) = gate(y), d(dx)/dy = 0
    (maua_tpu/ops/pallas_act.py:140-157)."""

    @staticmethod
    def forward(ctx, dy, y, negative_slope, scale):
        ctx.save_for_backward(y)
        ctx.act = (negative_slope, scale)
        if dy.device.type == "cpu":
            return fused_bias_act_grad_plain(dy, y, negative_slope, scale)
        return fused_bias_act_grad(dy.contiguous(), y, negative_slope, scale)

    @staticmethod
    def backward(ctx, ddx):
        (y,) = ctx.saved_tensors
        d_dy = FusedBiasActGradFunction.apply(ddx, y, *ctx.act) if ctx.needs_input_grad[0] else None
        return d_dy, None, None, None


class FusedBiasActFunction(torch.autograd.Function):
    """y = scale * leaky_relu(x + bias); backward (dx, db) from the saved y
    (maua_tpu/ops/pallas_act.py:110-137)."""

    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        if x.device.type == "cpu":
            y = fused_leaky_relu_plain(x, bias, negative_slope, scale)
        else:
            y = fused_bias_act(x.contiguous(), bias, negative_slope, scale)
        ctx.save_for_backward(y)
        ctx.act = (negative_slope, scale)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        dx = FusedBiasActGradFunction.apply(dy, y, *ctx.act)
        db = None
        if ctx.needs_input_grad[1]:
            axes = [0] + list(range(2, dx.ndim)) if dx.ndim >= 3 else list(range(dx.ndim - 1))
            db = (dx.sum(dim=axes) if axes else dx).to(ctx.bias_dtype)
        return dx if ctx.needs_input_grad[0] else None, db, None, None


def fused_leaky_relu(
    x: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
    scale: float = SQRT2,
) -> torch.Tensor:
    """CPU tensor -> plain form; CUDA tensor -> the kernels (or an error).
    Differentiable to any order on both devices."""
    return FusedBiasActFunction.apply(x, bias, negative_slope, scale)

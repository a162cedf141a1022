"""Fused bias-add + scaled leaky-ReLU: `scale * leaky_relu(x + bias)`.

Two forms of one function (maua_tpu/ops/fused_act.py:31-49 and the Pallas
kernel of maua_tpu/ops/pallas_act.py:93-107):

* `fused_bias_act` launches the hand-written CUDA kernel
  (csrc/fused_bias_act.cu) on a CUDA tensor and counts the launch in
  `launches`;
* `fused_leaky_relu_plain` is the same arithmetic in plain PyTorch.

`fused_leaky_relu` dispatches on where the tensor lies: CPU tensors take the
plain form, CUDA tensors the kernel, and nothing falls back from one to the
other. The bias is broadcast on axis 1 for >= 3-D input and on the last axis
for 1-D / 2-D input. Only the forward is ported: a CUDA tensor that needs a
gradient raises until the backward kernel comes with the training slice.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

__all__ = ["fused_bias_act", "fused_leaky_relu", "fused_leaky_relu_plain", "launches"]

SQRT2 = math.sqrt(2.0)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # CUDA kernel launches made by fused_bias_act in this process


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


def fused_bias_act(
    x: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
    scale: float = SQRT2,
) -> torch.Tensor:
    """Launch the CUDA kernel. x: contiguous fp32 or bf16 CUDA tensor; bias:
    [C] on the same device, read as fp32 (so bf16 input rounds once, on the
    store, where the plain form rounds the bias add too)."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"fused_bias_act needs a CUDA tensor, got one on {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or (bias is not None and bias.requires_grad)):
        raise NotImplementedError(
            "fused_bias_act has no backward yet: the backward kernel comes with the "
            "training slice; call it under torch.inference_mode() or torch.no_grad()"
        )
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_bias_act takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_bias_act needs a contiguous input")
    if x.ndim == 0:
        raise ValueError("fused_bias_act needs an input with at least one dimension")
    channels = x.shape[1] if x.ndim >= 3 else x.shape[-1]
    if bias is not None:
        if bias.ndim != 1 or bias.shape[0] != channels or bias.device != x.device:
            raise ValueError(
                f"bias must be [{channels}] on {x.device}, got {list(bias.shape)} on {bias.device}"
            )
        bias = bias.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    if x.ndim >= 3:
        rows, cols, on_rows = x.shape[0] * channels, math.prod(x.shape[2:]), 1
    else:
        rows, cols, on_rows = x.numel() // channels, channels, 0
    fn = _build.library("fused_bias_act").fused_bias_act
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            rows, cols, channels, on_rows, _DTYPE_CODES[x.dtype],
            negative_slope, scale, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_bias_act: CUDA error {err} at launch")
    launches += 1
    return out


def fused_leaky_relu(
    x: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
    scale: float = SQRT2,
) -> torch.Tensor:
    """CPU tensor -> plain form; CUDA tensor -> the kernel (or an error)."""
    if x.device.type == "cpu":
        return fused_leaky_relu_plain(x, bias, negative_slope, scale)
    return fused_bias_act(x, bias, negative_slope, scale)

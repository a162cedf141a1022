"""Ops: fused bias + leaky-ReLU and upfirdn2d (CUDA kernels and plain forms)."""

from .fused_act import fused_bias_act, fused_leaky_relu, fused_leaky_relu_plain
from .upfirdn2d import setup_filter, upfirdn2d

__all__ = ["fused_bias_act", "fused_leaky_relu", "fused_leaky_relu_plain", "setup_filter", "upfirdn2d"]

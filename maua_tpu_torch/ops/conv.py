"""2-D convolution whose derivatives of every order are cuDNN's own forward,
dgrad and wgrad.

The models' convs (`EqualConv2d`, `ModulatedConv2d`) enter `conv2d` and
`conv_transpose2d`. Without a gradient to record (grad mode off, or neither
input requires one) they are `F.conv2d` and `F.conv_transpose2d`, the same
call as before. With one they run through two autograd Functions:

* `_Conv`: y = conv(x, w); backward, given gy, gx = dgrad(gy, w) and
  gw = wgrad(x, gy), one `convolution_backward` call as autograd makes it.
  In a backward that records a graph (`create_graph`, R1 and the path
  penalty) that call is `_ConvBackward`, so the gradient can be
  differentiated again.
* `_ConvBackward`: forward (gx, gw) as above; backward, given (ggx, ggw):
      d/d gy = conv(ggx, w) + conv(x, ggw)
      d/d w  = wgrad(ggx, gy)
      d/d x  = dgrad(gy, ggw)
  each built from `_Conv` and `_ConvBackward` again, so the result can be
  differentiated to any order.

Autograd's own rule for `convolution_backward` (`_convolution_double_backward`)
computes d/d w as a convolution of ggx with gy, batch and channels
transposed, whose kernel is the whole output map (1024 x 1024 at the top of
the discriminator): cuDNN has no fast algorithm for that shape. Here it is the
ordinary weight gradient, of the cost of one more backward.

Each backward computes only the gradients that the running backward pass
uses, as autograd's own convolution node does: an input's gradient is
computed when it requires one and the engine will run its node. A leaf's
node cannot be asked about (it is an input of `autograd.grad`), so a leaf
takes its gradient whenever it requires one.

`second_order` counts `_ConvBackward.backward` calls in this process; while a
profiler records, each also counts `conv.second_order` under the span that
was innermost when the forward conv ran (`telemetry.count`), since autograd
runs a CUDA backward on a thread of its own.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ..telemetry import profiling

__all__ = ["conv2d", "conv_transpose2d", "second_order"]

second_order = 0  # _ConvBackward.backward calls in this process

# A geometry is (stride, padding, dilation, transposed, output_padding, groups),
# the arguments that torch.convolution and convolution_backward take.
Geometry = tuple[list[int], list[int], list[int], bool, list[int], int]


def _records(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """F.conv2d(x, w, stride=stride, padding=padding), no bias."""
    if not _records(x, w):
        return F.conv2d(x, w, stride=stride, padding=padding)
    geometry = ([stride] * 2, [padding] * 2, [1, 1], False, [0, 0], 1)
    return _Conv.apply(x, w, geometry, profiling.current_span())


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """F.conv_transpose2d(x, w, stride=stride), no bias; w is [in, out, kh, kw]."""
    if not _records(x, w):
        return F.conv_transpose2d(x, w, stride=stride)
    geometry = ([stride] * 2, [0, 0], [1, 1], True, [0, 0], 1)
    return _Conv.apply(x, w, geometry, profiling.current_span())


def _forward(x: torch.Tensor, w: torch.Tensor, geometry: Geometry) -> torch.Tensor:
    return torch.convolution(x, w, None, *geometry)


def _backward(gy, x, w, geometry: Geometry, mask: Sequence[bool]):
    """(dgrad(gy, w) or None, wgrad(x, gy) or None), as `mask` asks."""
    gx, gw, _ = torch.ops.aten.convolution_backward(gy, x, w, None, *geometry, [mask[0], mask[1], False])
    return gx, gw


def _conv(x, w, geometry: Geometry, span):
    """conv(x, w), differentiable while grad mode is on."""
    if _records(x, w):
        return _Conv.apply(x, w, geometry, span)
    return _forward(x, w, geometry)


def _conv_backward(gy, x, w, geometry: Geometry, mask: tuple[bool, bool], span):
    """_backward, differentiable while grad mode is on."""
    if _records(gy, x, w):
        return _ConvBackward.apply(gy, x, w, geometry, mask, span)
    return _backward(gy, x, w, geometry, mask)


def _nodes(*tensors: torch.Tensor) -> tuple:
    return tuple(t.grad_fn for t in tensors)


def _needed(ctx) -> list[bool]:
    """Per input: it requires a gradient, and the running backward will use
    it (asked of the engine for a non-leaf; always for a leaf)."""
    return [need and (node is None or torch._C._will_engine_execute_node(node))
            for need, node in zip(ctx.needs_input_grad, ctx.nodes)]


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, geometry, span):
        ctx.save_for_backward(x, w)
        ctx.geometry, ctx.span, ctx.nodes = geometry, span, _nodes(x, w)
        return _forward(x, w, geometry)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        mask = tuple(_needed(ctx))
        if not any(mask):
            return None, None, None, None
        if torch.is_grad_enabled():
            gx, gw = _ConvBackward.apply(gy, x, w, ctx.geometry, mask, ctx.span)
        else:
            gx, gw = _backward(gy, x, w, ctx.geometry, mask)
        return gx, gw, None, None


class _ConvBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gy, x, w, geometry, mask, span):
        ctx.save_for_backward(gy, x, w)
        ctx.geometry, ctx.span, ctx.nodes = geometry, span, _nodes(gy, x, w)
        ctx.set_materialize_grads(False)
        return _backward(gy, x, w, geometry, mask)

    @staticmethod
    def backward(ctx, ggx, ggw):
        global second_order
        second_order += 1
        profiling.count("conv.second_order", span=ctx.span)
        gy, x, w = ctx.saved_tensors
        need_gy, need_x, need_w = _needed(ctx)
        geometry, span = ctx.geometry, ctx.span
        g_gy = g_x = g_w = None
        if need_gy and ggx is not None:
            g_gy = _conv(ggx, w, geometry, span)
        if need_gy and ggw is not None:
            term = _conv(x, ggw, geometry, span)
            g_gy = term if g_gy is None else g_gy + term
        if need_x and ggw is not None:
            g_x = _conv_backward(gy, x, ggw, geometry, (True, False), span)[0]
        if need_w and ggx is not None:
            g_w = _conv_backward(gy, ggx, w, geometry, (False, True), span)[1]
        return g_gy, g_x, g_w, None, None, None

"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card: the fused bias + leaky-ReLU forward and its gradient kernel, at the
render and training shapes, and the two autograd Functions that carry them
(first order and the double backward of R1 and the path penalty). Marked `cuda`: they skip where torch.cuda.is_available() is False (a
CUDA kernel has no CPU mode). This file imports no JAX, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest tests/test_torch_port_kernels.py -q
"""

import numpy as np
import pytest
import torch

from maua_tpu_torch.ops import fused_act
from maua_tpu_torch.ops.fused_act import (
    fused_bias_act,
    fused_bias_act_grad,
    fused_bias_act_grad_plain,
    fused_leaky_relu,
    fused_leaky_relu_plain,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


def _x_and_bias(shape, with_bias, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    channels = shape[1] if len(shape) >= 3 else shape[-1]
    b = rng.randn(channels).astype(np.float32) if with_bias else None
    return x, b


# the last two: the VAE's batch-norm outputs on 4x4 and 2x2 maps (rows of 16 and 4 elements)
KERNEL_SHAPES = [(8, 512), (8, 512, 4, 4), (8, 512, 64, 64), (8, 32, 256, 256), (3, 130), (2, 3, 5, 7),
                 (64, 256, 4, 4), (64, 512, 2, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", KERNEL_SHAPES)
@pytest.mark.parametrize("with_bias", [True, False])
def test_kernel_matches_plain(cuda, shape, dtype, with_bias):
    """fp32: rtol = atol = 1e-6. bf16: two bf16 ulps (rtol 1.6e-2, atol 1e-2);
    the kernel rounds once on the store, the plain form also rounds the bias
    add. The bias is drawn bf16-representable, so that the plain form's cast
    of it to bf16 is exact (an fp32 bias of |b| ~ 4 alone would move results
    near zero by ~0.011)."""
    x, b = _x_and_bias(shape, with_bias, seed=2)
    dt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(cuda, dt)
    bt = None if b is None else torch.from_numpy(b).to(cuda, dt).float()
    before = fused_act.launches
    got = fused_bias_act(xt, bt)
    torch.cuda.synchronize()
    assert fused_act.launches == before + 1
    want = fused_leaky_relu_plain(xt, bt)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=1.6e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)


# activations of the training path at 256^2, batch 12 (G: 2x12 W+ mapping and
# the 512..128-channel StyledConvs; D: the interleaved batch of 24) and odd ones
GRAD_SHAPES = [(12, 512), (24, 1), (12, 512, 4, 4), (12, 512, 32, 32), (12, 128, 256, 256),
               (24, 128, 256, 256), (24, 512, 16, 16), (3, 130), (2, 3, 5, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", GRAD_SHAPES)
def test_grad_kernel_matches_plain(cuda, shape, dtype):
    """dx = dy * gate(y): exact in fp32 and bf16 (both compute the gain and
    the product in fp32 and round once)."""
    rng = np.random.RandomState(3)
    dt = getattr(torch, dtype)
    dy = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda, dt)
    y = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(cuda, dt)
    before = fused_act.grad_launches
    got = fused_bias_act_grad(dy, y)
    torch.cuda.synchronize()
    assert fused_act.grad_launches == before + 1
    torch.testing.assert_close(got, fused_bias_act_grad_plain(dy, y), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(12, 512), (12, 64, 32, 32), (3, 130)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_first_order_through_the_kernels(cuda, shape, dtype, with_bias):
    """(dx, db) of sum(y^2) through the Functions on the card against plain
    autograd of fused_leaky_relu_plain; both kernels launch. fp32: rtol 1e-5.
    bf16: dx to two ulps; db is the sum of the kernel's dx in dx's dtype,
    checked exactly against that sum (a sum of bf16 values that cancel has no
    useful relative tolerance against another rounding of the same terms)."""
    x, b = _x_and_bias(shape, with_bias, seed=4)
    dt = getattr(torch, dtype)
    outs = []
    for fn in (fused_leaky_relu, fused_leaky_relu_plain):
        xt = torch.from_numpy(x).to(cuda, dt).requires_grad_()
        bt = None if b is None else torch.from_numpy(b).to(cuda, dt).float().requires_grad_()
        before = (fused_act.launches, fused_act.grad_launches)
        loss = (fn(xt, bt).float() ** 2).sum()
        outs.append(torch.autograd.grad(loss, [xt] + ([bt] if with_bias else [])))
        if fn is fused_leaky_relu:
            assert (fused_act.launches, fused_act.grad_launches) == (before[0] + 1, before[1] + 1)
    (got, want) = outs
    if dtype == "float32":
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        return
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=1.6e-2, atol=1e-2)
    if with_bias:
        axes = [0] + list(range(2, len(shape))) if len(shape) >= 3 else [0]
        torch.testing.assert_close(got[1], got[0].sum(dim=axes).float(), rtol=0, atol=0)


@pytest.mark.cuda
def test_double_backward_through_the_kernels(cuda):
    """The R1 pattern, grad of a grad-norm, fp32: against plain autograd to
    rtol 1e-5. The gradient kernel launches three times: once in the first
    backward, and twice in the second: the gate applied to the tangent, and
    the forward node's backward again, since dy = 2y depends on the output."""
    x, b = _x_and_bias((4, 32, 8, 8), True, seed=5)
    outs = []
    for fn in (fused_leaky_relu, fused_leaky_relu_plain):
        xt = torch.from_numpy(x).to(cuda).requires_grad_()
        bt = torch.from_numpy(b).to(cuda).requires_grad_()
        before = fused_act.grad_launches
        (gx,) = torch.autograd.grad((fn(xt, bt) ** 2).sum(), xt, create_graph=True)
        outs.append(torch.autograd.grad((gx**2).sum(), [xt, bt]))
        if fn is fused_leaky_relu:
            assert fused_act.grad_launches == before + 3
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    """A CUDA tensor that needs a gradient runs the backward kernel (no
    error, no fallback); the raw wrappers refuse layouts and types they do
    not take."""
    x = torch.randn(2, 8, 4, 4, device=cuda).requires_grad_()
    before = fused_act.grad_launches
    fused_leaky_relu(x, None).sum().backward()
    torch.cuda.synchronize()
    assert fused_act.grad_launches == before + 1 and x.grad is not None
    with pytest.raises(ValueError, match="contiguous"):
        fused_bias_act(torch.randn(2, 4, 4, 8, device=cuda).permute(0, 3, 1, 2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_bias_act(torch.randn(2, 8, 4, 4, device=cuda).half())
    with pytest.raises(ValueError, match="bias"):
        fused_bias_act(torch.randn(2, 8, 4, 4, device=cuda), torch.randn(4, device=cuda))
    with pytest.raises(ValueError, match="agree"):
        fused_bias_act_grad(torch.randn(2, 8, device=cuda), torch.randn(2, 8, device=cuda).bfloat16())
    with pytest.raises(ValueError, match="CUDA"):
        fused_bias_act_grad(torch.randn(2, 8), torch.randn(2, 8))

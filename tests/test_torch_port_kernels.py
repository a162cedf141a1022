"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card: the fused bias + leaky-ReLU forward and its gradient kernel, at the
render and training shapes, and the two autograd Functions that carry them
(first order and the double backward of R1 and the path penalty); the
upfirdn2d kernel at every geometry the package builds, its autograd Function
to second order, its determinism and what it refuses. Marked `cuda`: they
skip where torch.cuda.is_available() is False (a CUDA kernel has no CPU mode). This file imports no JAX, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest tests/test_torch_port_kernels.py -q
"""

import importlib

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
from maua_tpu_torch.ops.upfirdn2d import setup_filter, upfirdn2d, upfirdn2d_kernel, upfirdn2d_plain

fir = importlib.import_module("maua_tpu_torch.ops.upfirdn2d")  # the package exports a function of that name


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


# upfirdn2d: (input shape, taps, up, down, pad (x0, x1, y0, y1)). The models'
# sites: the blur after each transposed conv ([1, 3, 3, 1] x 4, pad 1, 1) on
# 2r + 1 planes, its backward (pad 2, 2), D's blurs (2, 2) and skips (1, 1),
# the skips' Upsample (up 2, pad 2, 1) and its backward (down 2, pad 1, 1) at
# odd and non-square sizes, G's and D's small planes; ADA's SYM6 pair; a
# negative pad with a 3 x 4 filter; StyleGAN1's [1, 2, 1] blur at 1024^2 and 8^2.
BLUR4 = [1, 3, 3, 1]
FIR_CASES = {
    "sg1_blur_1024": ((8, 16, 1024, 1024), ([1, 2, 1], 1.0), 1, 1, (1, 1, 1, 1)),
    "sg1_blur_8": ((8, 512, 8, 8), ([1, 2, 1], 1.0), 1, 1, (1, 1, 1, 1)),
    "blur_up_1025": ((2, 4, 1025, 1025), (BLUR4, 4.0), 1, 1, (1, 1, 1, 1)),
    "blur_up_17": ((8, 32, 17, 17), (BLUR4, 4.0), 1, 1, (1, 1, 1, 1)),
    "blur_up_9": ((12, 512, 9, 9), (BLUR4, 4.0), 1, 1, (1, 1, 1, 1)),
    "blur_back_64": ((2, 8, 64, 64), (BLUR4, 4.0), 1, 1, (2, 2, 2, 2)),
    "d_blur_4": ((12, 512, 4, 4), (BLUR4, 1.0), 1, 1, (2, 2, 2, 2)),
    "d_blur_odd": ((3, 5, 31, 45), (BLUR4, 1.0), 1, 1, (2, 2, 2, 2)),
    "d_skip_16": ((24, 512, 16, 16), (BLUR4, 1.0), 1, 1, (1, 1, 1, 1)),
    "upsample_512": ((8, 3, 512, 512), (BLUR4, 4.0), 2, 1, (2, 1, 2, 1)),
    "upsample_odd": ((2, 3, 37, 21), (BLUR4, 4.0), 2, 1, (2, 1, 2, 1)),
    "upsample_4": ((12, 3, 4, 4), (BLUR4, 4.0), 2, 1, (2, 1, 2, 1)),
    "downsample_1024": ((8, 3, 1024, 1024), (BLUR4, 4.0), 1, 2, (1, 1, 1, 1)),
    "downsample_odd": ((2, 3, 37, 21), (BLUR4, 4.0), 1, 2, (1, 1, 1, 1)),
    "ada_up": ((4, 3, 96, 80), ("sym6", None), 2, 1, (6, 5, 6, 5)),
    "ada_down": ((4, 3, 192, 160), ("sym6", None), 1, 2, (5, 5, 5, 5)),
    "negative_pad": ((2, 3, 20, 17), ("3x4", None), 1, 1, (-1, 2, 0, 3)),
}


def _fir_inputs(case, dtype, device, seed=0):
    shape, (taps, gain), up, down, pad = FIR_CASES[case]
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device, dtype)
    if taps == "sym6":
        from maua_tpu_torch.train.augment import SYM6

        k = torch.outer(torch.tensor(SYM6), torch.tensor(SYM6))
    elif taps == "3x4":
        k = torch.from_numpy(rng.rand(3, 4).astype(np.float32))
    else:
        k = setup_filter(taps, gain=gain)
    return x, k.to(device), (up, up), (down, down), pad


@pytest.fixture
def no_tf32():
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = before


@pytest.mark.cuda
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(FIR_CASES))
def test_upfirdn2d_kernel_matches_plain(cuda, no_tf32, case, dtype, flip):
    """One launch against the plain form on the card, and against float64
    from the same (rounded) inputs and taps. fp32: rtol = atol = 1e-5 to both.
    bf16: to the plain form two bf16 ulps (rtol 1.6e-2, atol 1e-2); to float64
    one rounding of the fp32 sum (rtol 8e-3, atol 1e-6)."""
    dt = getattr(torch, dtype)
    x, k, up, down, pad = _fir_inputs(case, dt, cuda)
    before = fir.launches
    got = upfirdn2d_kernel(x, k, up, down, pad, flip)
    torch.cuda.synchronize()
    assert fir.launches == before + 1 and got.dtype == dt and got.is_contiguous()
    want = upfirdn2d_plain(x, k, up, down, pad, flip)
    exact = upfirdn2d_plain(x.double(), k.to(dt).double(), up, down, pad, flip)
    assert got.shape == want.shape == exact.shape
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got.double(), exact, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2, atol=1e-2)
        torch.testing.assert_close(got.double(), exact, rtol=8e-3, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upfirdn2d_kernel_on_strided_inputs(cuda, dtype):
    """A channel slice (strided N and C, dense planes) runs in place; a
    transposed input goes through `upfirdn2d`'s copy; a storage offset that
    breaks 16-byte alignment takes single-element loads. All equal the
    kernel on a contiguous copy, bit for bit."""
    dt = getattr(torch, dtype)
    big = torch.randn(4, 9, 33, 33, device=cuda).to(dt)
    k = setup_filter(BLUR4, gain=4.0).to(cuda)
    sliced = big[:, 2:7]
    assert not sliced.is_contiguous()
    want = upfirdn2d_kernel(sliced.contiguous(), k, pad=(1, 1, 1, 1))
    assert torch.equal(upfirdn2d_kernel(sliced, k, pad=(1, 1, 1, 1)), want)
    offset = big.reshape(-1)[1:1 + 4 * 5 * 33 * 33].reshape(4, 5, 33, 33)
    assert torch.equal(upfirdn2d_kernel(offset, k, pad=(1, 1, 1, 1)),
                       upfirdn2d_kernel(offset.contiguous(), k, pad=(1, 1, 1, 1)))
    t = big[:, :5].transpose(2, 3)
    torch.testing.assert_close(upfirdn2d(t, k, pad=1), upfirdn2d_kernel(t.contiguous(), k, pad=(1, 1, 1, 1)),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_upfirdn2d_kernel_is_deterministic(cuda):
    """Two launches on the same input give the same bits (no atomics)."""
    x, k, up, down, pad = _fir_inputs("blur_up_1025", torch.float32, cuda, seed=7)
    a = upfirdn2d_kernel(x, k, up, down, pad)
    b = upfirdn2d_kernel(x, k, up, down, pad)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["blur_up_17", "d_blur_odd", "upsample_odd", "downsample_odd", "ada_up",
                                  "negative_pad"])
def test_upfirdn2d_function_to_second_order(cuda, no_tf32, case):
    """First order and the grad of a grad-norm through `upfirdn2d` (the
    kernel, four launches) against autograd of the plain form's conv on the
    card, fp32: rtol 1e-5, atol 1e-5 of the largest magnitude (sums of up to
    144 terms of magnitude ~100 in another order)."""
    x0, k, up, down, pad = _fir_inputs(case, torch.float32, cuda, seed=3)
    outs = []
    for form in ("kernel", "plain"):
        x = x0.clone().requires_grad_()
        before = fir.launches
        y = upfirdn2d(x, k, up, down, pad) if form == "kernel" else upfirdn2d_plain(x, k, up, down, pad)
        (g,) = torch.autograd.grad((y**3).sum(), x, create_graph=True)
        (gg,) = torch.autograd.grad((g**2).sum(), x)
        outs.append((y.detach(), g.detach(), gg))
        assert fir.launches == before + (4 if form == "kernel" else 0)
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
def test_upfirdn2d_is_one_launch_and_no_sync(cuda):
    """A blur on the card: one kernel, named upfirdn2d, no depthwise conv,
    no copy, and no host sync (the taps are read on the device)."""
    x = torch.randn(2, 8, 33, 33, device=cuda)
    k = setup_filter(BLUR4, gain=4.0).to(cuda)
    upfirdn2d(x, k, pad=(1, 1))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        upfirdn2d(x, k, pad=(1, 1))
        upfirdn2d(x, k, up=2, pad=(2, 1))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        upfirdn2d(x, k, pad=(1, 1))
        upfirdn2d(x, k, up=2, pad=(2, 1))
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 2 and all("upfirdn2d" in n for n in names), names


@pytest.mark.cuda
def test_stylegan1_forward_is_eight_fir_launches_and_no_sync(cuda):
    """A 1024^2 StyleGAN1 synthesis at full width: one upfirdn2d launch per
    up-conv's blur (8), and no synchronizing call in its `sg1.synthesis` span."""
    from maua_tpu_torch import telemetry
    from maua_tpu_torch.models.stylegan1 import StyleGAN1, nf

    torch.manual_seed(0)
    model = StyleGAN1(1024, [nf(r - 1) for r in range(2, 11)]).to(cuda).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.normal_()
        w = torch.randn(2, model.n_latent, model.style_dim, device=cuda)
        model(w)
        torch.cuda.synchronize()
        before = fir.launches
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            telemetry.reset()
            img, _ = model(w)
            torch.cuda.synchronize()
        spans = telemetry.recorded()
    assert fir.launches - before == 8
    assert img.shape == (2, 3, 1024, 1024) and bool(torch.isfinite(img).all())
    assert spans["sg1.synthesis"]["count"] == 1 and spans["sg1.up"]["count"] == 8
    assert spans["sg1.epilogue"]["count"] == 18
    assert spans["sg1.synthesis"]["counters"].get("cuda.syncs", 0) == 0


@pytest.mark.cuda
def test_upfirdn2d_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.randn(2, 3, 8, 8, device=cuda)
    k = setup_filter(BLUR4).to(cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        upfirdn2d_kernel(x.half(), k, pad=(1, 1, 1, 1))
    with pytest.raises(ValueError, match="planes"):
        upfirdn2d_kernel(x.transpose(2, 3), k, pad=(1, 1, 1, 1))
    with pytest.raises(ValueError, match="float32 taps"):
        upfirdn2d_kernel(x, k.bfloat16(), pad=(1, 1, 1, 1))
    with pytest.raises(ValueError, match="float32 taps"):
        upfirdn2d_kernel(x, k.cpu(), pad=(1, 1, 1, 1))
    with pytest.raises(ValueError, match="same on both"):
        upfirdn2d(x, k, up=(1, 2), pad=(2, 1))
    with pytest.raises(ValueError, match="not both"):
        upfirdn2d(x, k, up=2, down=2, pad=(1, 1))
    with pytest.raises(ValueError, match="taps"):
        upfirdn2d(x, torch.ones(13, 13, device=cuda), pad=(6, 6))
    with pytest.raises(ValueError, match="only with up or down 2"):
        upfirdn2d(x, torch.ones(5, 5, device=cuda), pad=(2, 2))

"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`: they skip where torch.cuda.is_available() is False (a
CUDA kernel has no CPU mode). This file imports no JAX, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest tests/test_torch_port_kernels.py -q
"""

import numpy as np
import pytest
import torch

from maua_tpu_torch.ops import fused_act
from maua_tpu_torch.ops.fused_act import fused_bias_act, fused_leaky_relu, fused_leaky_relu_plain


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


KERNEL_SHAPES = [(8, 512), (8, 512, 4, 4), (8, 512, 64, 64), (8, 32, 256, 256), (3, 130), (2, 3, 5, 7)]


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


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.randn(2, 8, 4, 4, device=cuda)
    with pytest.raises(NotImplementedError, match="training slice"):
        fused_leaky_relu(x.requires_grad_(), None)
    with pytest.raises(ValueError, match="contiguous"):
        fused_bias_act(torch.randn(2, 4, 4, 8, device=cuda).permute(0, 3, 1, 2))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_bias_act(torch.randn(2, 8, 4, 4, device=cuda).half())
    with pytest.raises(ValueError, match="bias"):
        fused_bias_act(torch.randn(2, 8, 4, 4, device=cuda), torch.randn(4, device=cuda))

"""maua_tpu_torch.ops against maua_tpu.ops on the CPU: the plain fused bias +
leaky-ReLU against both JAX forms (plain jnp and the Pallas kernel in
interpret mode), upfirdn2d against the JAX op and its numpy oracle, the
dispatch rule, and the kernel build. The kernel against its plain form on
the card is in test_torch_port_kernels.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.ops.fused_act import fused_leaky_relu as jax_fused_leaky_relu
from maua_tpu.ops.pallas_act import fused_leaky_relu_pallas
from maua_tpu.ops.upfirdn2d import setup_filter as jax_setup_filter
from maua_tpu.ops.upfirdn2d import upfirdn2d as jax_upfirdn2d
from maua_tpu.ops.upfirdn2d import upfirdn2d_native
from maua_tpu_torch.ops import _build, fused_act
from maua_tpu_torch.ops.fused_act import fused_bias_act, fused_leaky_relu, fused_leaky_relu_plain
from maua_tpu_torch.ops.upfirdn2d import setup_filter, upfirdn2d


def _x_and_bias(shape, with_bias, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    channels = shape[1] if len(shape) >= 3 else shape[-1]
    b = rng.randn(channels).astype(np.float32) if with_bias else None
    return x, b


FLR_CASES = [
    ((2, 8, 4, 4), True),
    ((2, 16, 16, 16), True),
    ((3, 130), True),
    ((4, 512), True),
    ((2, 8, 4, 4), False),
    ((4, 512), False),
]


@pytest.mark.parametrize("shape,with_bias", FLR_CASES)
def test_fused_leaky_relu_plain_matches_jax(shape, with_bias):
    """fp32, rtol = atol = 1e-6 against the jnp form and the Pallas kernel."""
    x, b = _x_and_bias(shape, with_bias)
    got = fused_leaky_relu_plain(torch.from_numpy(x), None if b is None else torch.from_numpy(b)).numpy()
    jb = None if b is None else jnp.asarray(b)
    want = np.asarray(jax_fused_leaky_relu(jnp.asarray(x), jb))
    pallas = np.asarray(fused_leaky_relu_pallas(jnp.asarray(x), jb, 0.2, math.sqrt(2.0), True))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)


def test_dispatch_sends_cpu_tensors_to_plain(monkeypatch):
    """A CPU tensor takes the plain form without building or launching."""
    monkeypatch.setattr(fused_act, "launches", 0)

    def no_library(name):
        raise AssertionError("the CPU path must not load the CUDA library")

    monkeypatch.setattr(_build, "library", no_library)
    x = torch.randn(2, 8, 4, 4)
    b = torch.randn(8)
    assert torch.equal(fused_leaky_relu(x, b), fused_leaky_relu_plain(x, b))
    strided = torch.randn(3, 130)[:, ::2]  # the plain form takes any layout
    assert torch.equal(fused_leaky_relu(strided), fused_leaky_relu_plain(strided))
    assert fused_act.launches == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never computes the plain form itself."""
    with pytest.raises(ValueError, match="CUDA"):
        fused_bias_act(torch.randn(2, 8, 4, 4), torch.randn(8))


UPFIRDN_CASES = {
    "upsample": dict(up=2, pad=(2, 1), gain=4.0),  # blocks.py:188-193
    "downsample": dict(down=2, pad=(1, 1), gain=1.0),  # blocks.py:203-208
    "blur_up_path": dict(pad=(1, 1), gain=4.0),  # blocks.py:335-338
    "negative_pad": dict(pad=(-1, 2), gain=1.0),
    "pad4": dict(pad=(1, 2, 0, 3), gain=1.0),
    "up_1x2": dict(up=(1, 2), pad=(2, 1), gain=2.0),
}


@pytest.mark.parametrize("case", sorted(UPFIRDN_CASES))
def test_upfirdn2d_matches_jax_and_oracle(case):
    cfg = dict(UPFIRDN_CASES[case])
    gain = cfg.pop("gain")
    x = np.random.RandomState(1).randn(2, 3, 8, 6).astype(np.float32)
    k = np.asarray(jax_setup_filter([1, 3, 3, 1], gain=gain))
    got = upfirdn2d(torch.from_numpy(x), setup_filter([1, 3, 3, 1], gain=gain), **cfg).numpy()
    want = np.asarray(jax_upfirdn2d(jnp.asarray(x), jnp.asarray(k), **cfg))
    oracle = upfirdn2d_native(x, k, **cfg)
    assert got.shape == want.shape == oracle.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", sorted(UPFIRDN_CASES))
def test_upfirdn2d_gradients_match_jax(case):
    """First order and the grad of a grad-norm through upfirdn2d's autograd
    Function, with an asymmetric kernel, against jax.grad of the JAX op:
    rtol = atol = 1e-4 (fp32 sums in other orders)."""
    import jax

    cfg = dict(UPFIRDN_CASES[case])
    cfg.pop("gain")
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 8, 6).astype(np.float32)
    k = (np.arange(12, dtype=np.float32).reshape(3, 4) + 1) / 78

    def loss(f):
        return lambda x: (f(x) ** 3).sum()

    xt = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad(loss(lambda v: upfirdn2d(v, torch.from_numpy(k), **cfg))(xt), xt, create_graph=True)
    (gg,) = torch.autograd.grad((g**2).sum(), xt)
    jl = loss(lambda v: jax_upfirdn2d(v, jnp.asarray(k), **cfg))
    want_g = jax.grad(jl)(jnp.asarray(x))
    want_gg = jax.grad(lambda v: jnp.sum(jax.grad(jl)(v) ** 2))(jnp.asarray(x))
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gg.numpy(), np.asarray(want_gg), rtol=1e-4, atol=1e-4)


def test_setup_filter_matches_jax():
    for taps, kw in (([1, 3, 3, 1], {}), ([1, 3, 3, 1], {"gain": 4.0}), ([1, 2, 1], {"normalize": False})):
        np.testing.assert_allclose(
            setup_filter(taps, **kw).numpy(), np.asarray(jax_setup_filter(taps, **kw)), rtol=1e-7, atol=0
        )
    f2 = np.arange(1, 10, dtype=np.float32).reshape(3, 3)
    np.testing.assert_allclose(setup_filter(f2).numpy(), np.asarray(jax_setup_filter(f2)), rtol=1e-7)
    with pytest.raises(ValueError, match="1-D or 2-D"):
        setup_filter(np.ones((2, 2, 2)))


def test_build_without_nvcc_raises():
    """No stub: without the CUDA toolkit the build fails loudly, naming nvcc."""
    if _build.nvcc_path() is not None:
        pytest.skip("nvcc is available here; the kernels build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library("fused_bias_act")

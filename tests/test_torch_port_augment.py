"""maua_tpu_torch's ADA (train/augment.py, train/fft_warp.py, ops/gather.py)
against maua_tpu's, on the CPU.

The port keeps its random draws apart from the arithmetic: `jax_augment_draw`
rebuilds the port's AugmentDraw from the JAX package's own keys (the key
splits of `sample_augment_params`), so both packages assemble matrices from
the same variates. Tolerances: matrix assembly 1e-6; the warps in fp32 1e-5
for conv and matmul and 1e-4 for fft (two FFT libraries), the same for their
input gradients; dftmm against JAX's dftmm 1e-4 in fp32 and 2e-2 in bf16;
the fft warp's identity bypass and `ada_adjust_p` exact.
"""

from __future__ import annotations

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu_torch.ops.gather import bilinear_gather
from maua_tpu_torch.train.augment import AffineDraw, AugmentDraw, ColorDraw

# the packages export functions named `augment`: take the modules by name
jaug, jfft, taug, tfft = (importlib.import_module(m) for m in (
    "maua_tpu.train.augment", "maua_tpu.train.fft_warp", "maua_tpu_torch.train.augment", "maua_tpu_torch.train.fft_warp"))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def jax_augment_draw(rng, batch: int) -> AugmentDraw:
    """The port's AugmentDraw of the variates `maua_tpu.train.augment.
    sample_augment_params(rng, p, batch, ...)` draws, whatever p."""
    r1, r2 = jax.random.split(rng)
    k = jax.random.split(r1, 16)
    kc = jax.random.split(r2, 10)

    def u(key):
        return np.array(jax.random.uniform(key, (batch, 1, 1))).reshape(batch)

    def normal(key):
        return jax.random.normal(key, (batch,))

    def uniform(key, lo, hi):
        return jax.random.uniform(key, (batch,), minval=lo, maxval=hi)

    affine = AffineDraw(
        flip=_t(jax.random.bernoulli(k[0], 0.5, (batch,))),
        quarter=_t(jax.random.choice(k[2], jnp.array([0.0, 3.0]), (batch,))),
        t=_t(uniform(k[4], -0.125, 0.125)),
        s=_t(normal(k[6])),
        th_pre=_t(uniform(k[8], -math.pi, math.pi)),
        s2=_t(normal(k[10])),
        th_post=_t(uniform(k[12], -math.pi, math.pi)),
        tf=_t(normal(k[14])),
        u=_t(np.stack([u(k[i]) for i in (1, 3, 5, 7, 9, 11, 13, 15)])),
    )
    color = ColorDraw(
        b=_t(normal(kc[0])), c=_t(normal(kc[2])), lf=_t(jax.random.bernoulli(kc[4], 0.5, (batch,))),
        hue=_t(uniform(kc[6], -math.pi, math.pi)), sat=_t(normal(kc[8])),
        u=_t(np.stack([u(kc[i]) for i in (1, 3, 5, 7, 9)])),
    )
    return AugmentDraw(affine, color)


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, dtype=np.float32), rtol=0, atol=tol)


# ---------------------------------------------------------------- sampling
@pytest.mark.parametrize("p", [0.0, 0.3, 0.8, 1.0])
def test_matrix_assembly_from_jax_variates(p):
    """Affine [B, 3, 3] and colour [B, 4, 4] matrices assembled from JAX's
    variates equal JAX's sampled matrices to 1e-6."""
    rng, b, h, w = jax.random.PRNGKey(3), 64, 24, 20
    want = jaug.sample_augment_params(rng, jnp.asarray(p), b, h, w)
    got = taug.augment_params(jax_augment_draw(rng, b), torch.tensor(p), h, w)
    _close(got.affine, want.affine, 1e-6)
    _close(got.color, want.color, 1e-6)


def test_samplers_p0_identity_and_p1_statistics():
    """p = 0: every matrix is the identity. p = 1, 4096 samples of each
    package: the share of flips (det < 0) and the mean and spread of log|det|
    (twice the isotropic log-scale) agree within 3 sigma."""
    n = 4096
    draw = taug.draw_augment(n, torch.Generator().manual_seed(0), "cpu")
    zero = taug.augment_params(draw, torch.tensor(0.0), 16, 16)
    torch.testing.assert_close(zero.affine, torch.eye(3).expand(n, 3, 3), rtol=0, atol=0)
    torch.testing.assert_close(zero.color, torch.eye(4).expand(n, 4, 4), rtol=0, atol=0)

    det_t = torch.linalg.det(taug.augment_params(draw, torch.tensor(1.0), 16, 16).affine).double().numpy()
    det_j = np.linalg.det(np.asarray(jaug.sample_affine(jax.random.PRNGKey(1), 1.0, n, 16, 16), dtype=np.float64))
    flips = [np.mean(d < 0) for d in (det_t, det_j)]
    assert abs(flips[0] - flips[1]) <= 3 * math.sqrt(2 * 0.25 / n), flips
    logs = [np.log(np.abs(d)) for d in (det_t, det_j)]
    sd = 0.4 * math.log(2.0)  # log|det| = 2 log s, s log-normal with sigma 0.2 ln 2
    assert abs(logs[0].mean() - logs[1].mean()) <= 3 * sd * math.sqrt(2 / n)
    assert abs(logs[0].std() - logs[1].std()) <= 3 * sd * math.sqrt(1 / n), (logs[0].std(), logs[1].std())


# ---------------------------------------------------------------- application
def _img(b, c, h, w, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (b, c, h, w)).astype(np.float32)


def _smooth(b, c, h, w, seed):
    """A smooth random field in [-1, 1] (products of random low-frequency
    sinusoids plus 5 % noise), pixel-to-pixel slopes like a photograph's.
    White noise would measure the sampling coordinates' last bit: the
    packages invert G by different routines, and one ulp of a coordinate
    moves a sample of noise by 1e-5 at 24^2, fp32's resolution, not the
    warp's arithmetic."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w] / 8.0
    f, ph = rng.uniform(0.3, 1.5, (b, c, 2)), rng.uniform(0, 2 * np.pi, (b, c, 2))
    field = np.sin(f[..., 0, None, None] * yy + ph[..., 0, None, None]) * np.cos(f[..., 1, None, None] * xx + ph[..., 1, None, None])
    return (0.9 * field + 0.05 * rng.uniform(-1, 1, (b, c, h, w))).astype(np.float32)


# name: (options, tolerance, (H, W), whether the JAX side runs jitted). The
# matmul cases run JAX eagerly: jitted, XLA reassociates the band matmuls'
# sums and its own image gradient moves by 1e-5.
WARPS = {
    "conv": (dict(method="conv"), 1e-5, (24, 20), True),
    "matmul": (dict(method="matmul"), 1e-5, (24, 20), False),
    "matmul_1x_grid": (dict(method="matmul", oversample_grid=False), 1e-5, (24, 20), False),
    "fft": (dict(method="fft"), 1e-4, (24, 24), True),
    "fft_taper_always": (dict(method="fft", fft_taper_conditional=False), 1e-4, (24, 24), True),
}


@pytest.mark.parametrize("name", sorted(WARPS))
def test_apply_affine_matches_jax(name):
    """Values and the input gradient of <warp(x), cotangent>, image and
    cotangent smooth fields, given the same matrices (JAX's, at p = 0.7)."""
    kw, tol, (h, w), jit = WARPS[name]
    x = _smooth(3, 3, h, w, seed=0)
    G = jaug.sample_affine(jax.random.PRNGKey(5), jnp.asarray(0.7), 3, h, w)
    cot = _smooth(3, 3, h, w, seed=1)
    warp = lambda a: jaug.apply_affine(a, G, **kw)  # noqa: E731
    both = lambda a: (warp(a), jax.grad(lambda b: jnp.sum(warp(b) * cot))(a))  # noqa: E731
    want, want_g = (jax.jit(both) if jit else both)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = taug.apply_affine(xt, _t(G), **kw)
    (got_g,) = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), xt)
    _close(got, want, tol)
    _close(got_g, want_g, tol)


def test_inv3_matches_float64_inverse():
    """inv3 (the adjugate, elementwise) against float64 inversion: within a
    few fp32 ulps; the coordinates need no batched LU, whose last bits
    differ between LAPACK and the card."""
    G = _t(jaug.sample_affine(jax.random.PRNGKey(9), jnp.asarray(1.0), 64, 32, 32))
    want = np.linalg.inv(G.double().numpy())
    np.testing.assert_allclose(taug.inv3(G).double().numpy(), want, rtol=0, atol=2e-6 * np.abs(want).max())


def test_apply_color_and_augment_match_jax():
    """apply_color (1e-6) and its gradient (1e-5), and augment() end to end from
    JAX's key (conv warp, and fft), given the rebuilt draws."""
    x = _smooth(4, 3, 16, 16, seed=2)
    C = jaug.sample_color(jax.random.PRNGKey(6), jnp.asarray(0.9), 4)
    xt = torch.from_numpy(x).requires_grad_()
    got = taug.apply_color(xt, _t(C))
    _close(got, jaug.apply_color(jnp.asarray(x), C), 1e-6)
    want_g = jax.grad(lambda a: jnp.sum(jaug.apply_color(a, C) ** 2))(jnp.asarray(x))
    _close(torch.autograd.grad((got**2).sum(), xt)[0], want_g, 1e-5)

    rng = jax.random.PRNGKey(7)
    draw = jax_augment_draw(rng, 4)
    for method, tol in ((None, 1e-5), ("fft", 1e-4)):
        want, params = jax.jit(lambda a: jaug.augment(a, jnp.asarray(0.6), rng=rng, warp_method=method))(jnp.asarray(x))
        got, tparams = taug.augment(torch.from_numpy(x), torch.tensor(0.6), draw, warp_method=method)
        _close(tparams.affine, params.affine, 1e-6)
        _close(got, want, tol)


def test_bilinear_gather_matches_jax_plain_sampler():
    """The one gather against `_bilinear_sample_plain`, out-of-range zeros
    included: values and the image gradient (its scatter-add) to 1e-6."""
    img = _img(2, 3, 9, 11, seed=3)
    coords = np.random.RandomState(4).uniform(-3, 13, (2, 2, 6, 7)).astype(np.float32) + 0.3
    cot = np.random.RandomState(5).randn(2, 3, 6, 7).astype(np.float32)
    want = jaug._bilinear_sample_plain(jnp.asarray(img), jnp.asarray(coords))
    want_g = jax.grad(lambda a: jnp.sum(jaug._bilinear_sample_plain(a, jnp.asarray(coords)) * cot))(jnp.asarray(img))
    it = torch.from_numpy(img).requires_grad_()
    got = bilinear_gather(it, torch.from_numpy(coords[:, 0]), torch.from_numpy(coords[:, 1]))
    _close(got, want, 1e-6)
    _close(torch.autograd.grad((got * torch.from_numpy(cot)).sum(), it)[0], want_g, 1e-6)


def test_method_none_is_conv_on_the_cpu_and_guards():
    x = torch.from_numpy(_img(2, 3, 16, 16))
    G = _t(jaug.sample_affine(jax.random.PRNGKey(8), jnp.asarray(0.9), 2, 16, 16))
    torch.testing.assert_close(taug.apply_affine(x, G), taug.apply_affine(x, G, method="conv"), rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="matmul"):
        taug.apply_affine(x, G, method="conv", oversample_grid=False)
    with pytest.raises(ValueError, match="square"):
        tfft.affine_warp_fft(torch.zeros(1, 3, 16, 32), torch.eye(3)[None])


# ---------------------------------------------------------------- fft warp
def _dftmm_case():
    h = 36
    rng = np.random.RandomState(0)
    img = (rng.rand(2, 3, h, h).astype(np.float32) * 2 - 1)
    c, s = np.cos(0.3), np.sin(0.3)
    G = np.stack([np.array([[1.0, 0.1, 0.08], [0.0, 1.0, -0.05], [0, 0, 1]], np.float32),
                  np.array([[c, -s, 0.0], [s, c, 0.0], [0, 0, 1]], np.float32)])
    return img, G, rng.uniform(-5, 5, (2, 1, h)).astype(np.float32)


def test_dftmm_matches_jax_dftmm():
    """The explicit shear_impl="dftmm" (DFT matmuls; bf16 operands with fp32
    accumulation) against the JAX package's: fp32 1e-4, bf16 2e-2; the raw
    row shear in fp32 1e-4; and the port's dftmm against its own fft 1e-4."""
    img, G, shift = _dftmm_case()
    jwarp = jax.jit(lambda a: jfft.affine_warp_fft(a, jnp.asarray(G), shear_impl="dftmm"))
    want = jwarp(jnp.asarray(img))
    got = tfft.affine_warp_fft(torch.from_numpy(img), torch.from_numpy(G), shear_impl="dftmm")
    _close(got, want, 1e-4)
    _close(got, tfft.affine_warp_fft(torch.from_numpy(img), torch.from_numpy(G), shear_impl="fft"), 1e-4)
    want_b = jwarp(jnp.asarray(img).astype(jnp.bfloat16))
    got_b = tfft.affine_warp_fft(torch.from_numpy(img).bfloat16(), torch.from_numpy(G), shear_impl="dftmm")
    assert got_b.dtype == torch.bfloat16
    _close(got_b, np.asarray(want_b.astype(jnp.float32)), 2e-2)
    for impl in ("fft", "dftmm"):
        a = jax.jit(lambda x, s: jfft._fft_shift_rows(x, s, 0.85, True, impl))(jnp.asarray(img), jnp.asarray(shift))
        b = tfft._fft_shift_rows(torch.from_numpy(img), torch.from_numpy(shift), 0.85, True, impl)
        _close(b, a, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fft_identity_bypass_is_bit_exact(dtype):
    """An identity G passes its image through unchanged, beside a sample that
    is warped; the lattice transforms (flip, integer translate) are exact to
    fp32 rounding with the default conditional taper."""
    x = torch.from_numpy(_img(2, 3, 32, 32, seed=9)).to(dtype)
    G = torch.stack([torch.eye(3), torch.tensor([[0.9, 0.2, 0.1], [-0.1, 1.1, 0.0], [0.0, 0.0, 1.0]])])
    out = tfft.affine_warp_fft(x, G)
    assert out.dtype == dtype
    torch.testing.assert_close(out[0], x[0], rtol=0, atol=0)
    assert (out[1].float() - x[1].float()).abs().max() > 0.1
    if dtype == torch.float32:
        flip = torch.diag(torch.tensor([-1.0, 1.0, 1.0]))[None].expand(2, 3, 3)
        torch.testing.assert_close(tfft.affine_warp_fft(x, flip), x.flip(-1), rtol=0, atol=1e-4)
        k = 5
        tr = torch.tensor([[1.0, 0.0, 2.0 * k / 32], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])[None].expand(2, 3, 3)
        padded = np.pad(x.numpy(), ((0, 0), (0, 0), (0, 0), (k, 0)), mode="reflect")[..., :32]
        _close(tfft.affine_warp_fft(x, tr), padded, 1e-4)


def test_next_smooth_and_scale_band_match_jax():
    for n in (16, 26, 386, 1538, 97):
        assert tfft.next_smooth(n) == jfft.next_smooth(n)
    sigma = np.array([1.0, -1.0, 1.7, 0.6], np.float32)
    gamma = np.array([3.0, 20.0, -2.0, 5.5], np.float32)
    _close(tfft._scale_band(12, 27, _t(sigma), _t(gamma)), jfft._scale_band(12, 27, jnp.asarray(sigma), jnp.asarray(gamma)), 1e-6)
    shift = np.array([[0.0, 2.5, -1.25, 30.0]], np.float32)
    _close(tfft._wrap_mask(27, _t(shift)), jfft._wrap_mask(27, jnp.asarray(shift)), 0)


# ---------------------------------------------------------------- adaptive p
@pytest.mark.parametrize("p,signs,n", [(0.3, 100.0, 200.0), (0.3, 200.0, 300.0), (0.3, -50.0, 300.0),
                                       (0.001, -300.0, 300.0), (0.999, 300.0, 300.0), (0.5, 0.0, 0.0)])
def test_ada_adjust_p_exact(p, signs, n):
    """Below the 256-prediction threshold nothing moves; above it p steps by
    +-(target / length) * n, clipped to [0, 1], and the counts reset."""
    want = jaug.ada_adjust_p(jnp.asarray(p, jnp.float32), jnp.asarray(signs, jnp.float32), jnp.asarray(n, jnp.float32),
                             0.6, 500.0)
    got = taug.ada_adjust_p(torch.tensor(p), torch.tensor(signs), torch.tensor(n), 0.6, 500.0)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.ndim == 0
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

"""maua_tpu_torch.eval against maua_tpu.eval on the CPU: the bilinear
resizes, the FID / PRDC math,
fid() with the reference's truncation protocol, ppl() with one shared
deterministic sampler and the end-to-end PPL of a generator, SWD, vae_fid
and the weights fingerprint. InceptionV3 is in test_torch_port_inception.py,
the CLIs are in test_torch_port_eval_cli.py.

The weights are fabricated from numpy seeds in torchvision's layout (He
normal convs, batch-norm statistics near identity), so the features stay
alive through the 94 convs; both packages load the same state dict.

Tolerances: resizes 1e-6 (each output is a short weighted sum of
inputs in [-1, 1], against the float64 evaluation of JAX's weights); FID / PRDC /
SWD from equal features 1e-9 relative (float64 numpy on both sides); ppl()
with one shared sampler 1e-5 relative at eps 1e-2 and 1e-3 at eps 1e-4; the
end-to-end PPL of two generators 2e-2 relative (each justified below)."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maua_tpu.eval.metrics as jmetrics
import maua_tpu.eval.swd as jswd
import maua_tpu_torch.eval.cli as tcli
import maua_tpu_torch.eval.metrics as tmetrics
import maua_tpu_torch.eval.swd as tswd
from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat
from maua_tpu.io import load_generator as jax_load_generator
from maua_tpu.models import Generator as JaxGenerator
from maua_tpu_torch.eval import InceptionV3
from maua_tpu_torch.io import generator_state_dict_from_jax, load_generator
from maua_tpu_torch.ops.resize import resize_bilinear
from test_torch_port_inference import Replay

def close(got, want, atol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= atol, f"max abs {err} > {atol}"


def inception_sd(seed: int = 0) -> dict:
    """A torchvision-layout InceptionV3 state dict: He-normal convs, batch
    norms near identity, and the AuxLogits / fc keys the loaders ignore."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in InceptionV3().state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("conv.weight"):
            sd[k] = (np.sqrt(2.0 / np.prod(shape[1:])) * rng.standard_normal(shape)).astype(np.float32)
        elif k.endswith("bn.weight"):
            sd[k] = (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        elif k.endswith(("bn.bias", "bn.running_mean")):
            sd[k] = (0.05 * rng.standard_normal(shape)).astype(np.float32)
        elif k.endswith("bn.running_var"):
            sd[k] = (1.0 + 0.1 * rng.random(shape)).astype(np.float32)
    sd["AuxLogits.fc.weight"] = np.zeros((4, 4), np.float32)
    sd["fc.weight"] = np.zeros((4, 4), np.float32)
    return sd


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A 32^2 generator (style_dim 512, n_mlp 8, channel_max 32) with JAX's
    initial weights moved by 0.2 N(0, 1), carried across."""
    gen = JaxGenerator(size=32, constant_input=True, channel_max=32)
    v = gen.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, jnp.zeros((1, 512)))
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.2 * rng.randn(*np.shape(a)).astype(np.float32), v["params"])
    buffers = {k: rng.randn(*np.shape(b)).astype(np.float32) for k, b in v["buffers"].items()}
    p = tmp_path_factory.mktemp("ckpt") / "g32.pt"
    torch.save({"g_ema": generator_state_dict_from_jax(params, buffers)}, str(p))
    return str(p)


@pytest.mark.parametrize("src,dst", [(256, 299), (1024, 299), (1024, 256), (1024, 64), (64, 32)])
def test_resize_matches_jax(src, dst):
    """resize_bilinear against jax.image.resize(..., "bilinear"), which
    antialiases when it shrinks: within 1e-6 of the float64 evaluation of
    JAX's own weight matrices, and within 1e-6 of jax.image.resize plus
    that function's own distance from the float64 result (JAX's fp32 einsum
    on the CPU lands up to 4e-6 from it at the non-integer ratios; at
    1024 -> 256 it is exact to 1e-7)."""
    x = np.tanh(np.random.default_rng(src + dst).standard_normal((2, 3, src, src))).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, dst, dst), "bilinear"))
    w = np.asarray(compute_weight_mat(src, dst, dst / src, 0.0, _fill_triangle_kernel, True), np.float64)
    exact = np.einsum("nchw,hH,wW->ncHW", x.astype(np.float64), w, w, optimize=True)
    got = resize_bilinear(torch.from_numpy(x), (dst, dst)).numpy()
    close(got, exact, 1e-6)
    close(got, want, 1e-6 + float(np.abs(want - exact).max()))
    if dst == 299:
        close(InceptionV3.preprocess(torch.from_numpy(x)), got, 0.0)


# ---------------------------------------------------------------- FID / PRDC / SWD
def test_fid_math_and_prdc_match_jax():
    rng = np.random.default_rng(2)
    real = rng.standard_normal((64, 12))
    fake = 0.8 * rng.standard_normal((48, 12)) + 0.3
    mu_r, s_r = tmetrics.compute_stats(real)
    for a, b in zip((mu_r, s_r), jmetrics.compute_stats(real)):
        np.testing.assert_allclose(a, b, rtol=1e-12)
    want = jmetrics.fid_from_features(fake, mu_r, s_r)
    assert abs(tmetrics.fid_from_features(fake, mu_r, s_r) - want) <= 1e-9 * abs(want)
    assert abs(tmetrics.frechet_distance(mu_r, s_r, mu_r, s_r)) < 1e-6
    # a singular product falls back to the eps offset in both
    sing = np.zeros((12, 12))
    assert tmetrics.frechet_distance(mu_r, sing, mu_r + 1, sing) == pytest.approx(
        jmetrics.frechet_distance(mu_r, sing, mu_r + 1, sing), rel=1e-9)
    assert tmetrics.prdc(real[:48], fake, nearest_k=3) == jmetrics.prdc(real[:48], fake, nearest_k=3)


def test_fid_truncation_protocol_matches_jax():
    """The same deterministic sampler (images from the call index and the
    truncation) in both packages: the per-batch truncations drawn U(0.9,
    1.5) from default_rng(0), a fixed truncation passed through, a sampler
    without a truncation argument, and the FID / PRDC values."""
    real = np.random.default_rng(3).standard_normal((40, 6)).astype(np.float32)
    stats = jmetrics.compute_stats(real)
    seen = {"j": [], "t": []}

    def sampler(tag, as_tensor):
        count = [0]

        def synthesize(_rng, batch, trunc):
            seen[tag].append(float(trunc))
            count[0] += 1
            x = np.random.default_rng(count[0]).standard_normal((batch, 6)).astype(np.float32) * float(trunc)
            return torch.from_numpy(x) if as_tensor else jnp.asarray(x)

        return synthesize

    for truncation in (None, 0.7):
        seen = {"j": [], "t": []}
        want = jmetrics.fid(sampler("j", False), lambda x: x, stats, n_sample=35, batch_size=10,
                            real_features=real, compute_prdc=True, truncation=truncation)
        got = tmetrics.fid(sampler("t", True), lambda x: x, stats, n_sample=35, batch_size=10, draws=object(),
                           real_features=real, compute_prdc=True, truncation=truncation)
        assert seen["t"] == seen["j"] and len(seen["t"]) == 4
        assert set(got) == set(want) == {"fid", "precision", "recall", "density", "coverage"}
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-9), k
    assert len(set(seen["t"])) == 1 and seen["t"][0] == 0.7

    def no_trunc(_rng, batch):
        return torch.ones(batch, 6)

    assert np.isfinite(tmetrics.fid(no_trunc, lambda x: x + torch.randn(x.shape, generator=torch.Generator().manual_seed(0)),
                                    stats, n_sample=8, batch_size=4, draws=object())["fid"])


def test_swd_matches_jax():
    """The port's copy of the numpy SWD on the same image sets: equal."""
    rng = np.random.RandomState(4)
    a = np.tanh(rng.randn(8, 3, 32, 32)).astype(np.float32)
    b = np.tanh(1.3 * rng.randn(8, 3, 32, 32)).astype(np.float32)
    got = tswd.swd(a, b, n_dirs=64, n_repeats=2)
    want = jswd.swd(a, b, n_dirs=64, n_repeats=2)
    assert set(got) == set(want) == {"swd_32", "swd_16", "swd_avg"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12)
    with pytest.raises(ValueError):
        tswd.swd(a, b[:4])


def test_vae_fid_and_cached_stats_match_jax(tmp_path):
    """vae_fid with the same reconstruct and features; cached_dataset_stats
    writes its pickle once and reads it back."""
    rng = np.random.default_rng(5)
    batches = [rng.standard_normal((6, 3, 8, 8)).astype(np.float32) for _ in range(4)]

    def feats_j(x):
        return jnp.concatenate([jnp.mean(x, axis=(2, 3)), jnp.std(x, axis=(2, 3))], axis=1)

    def feats_t(x):
        x = torch.as_tensor(x)
        return torch.cat([x.mean(dim=(2, 3)), x.std(dim=(2, 3), correction=0)], dim=1)

    want = jmetrics.vae_fid(lambda x: 0.5 * x, feats_j, iter(batches), n_sample=18)
    got = tmetrics.vae_fid(lambda x: 0.5 * torch.as_tensor(x), feats_t, iter(batches), n_sample=18)
    assert got == pytest.approx(want, rel=1e-5)

    cache = str(tmp_path / "stats.pkl")
    mu, sigma = tmetrics.cached_dataset_stats(feats_t, iter(batches), cache, max_items=12)
    mu_j, sigma_j = jmetrics.compute_stats(np.concatenate([np.asarray(feats_j(jnp.asarray(b))) for b in batches[:2]]))
    np.testing.assert_allclose(mu, mu_j, atol=1e-6)
    np.testing.assert_allclose(sigma, sigma_j, atol=1e-6)
    again = tmetrics.cached_dataset_stats(None, iter(()), cache)
    np.testing.assert_array_equal(again[0], mu)


def test_weights_fingerprint_matches_jax():
    """The same arrays under the same paths hash alike in both packages."""
    tree = {"a": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}, "b": np.ones(4, np.float32)}
    assert tmetrics.weights_fingerprint(tree) == jmetrics.weights_fingerprint(tree)
    as_torch = {"a": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}, "b": torch.ones(4)}
    assert tmetrics.weights_fingerprint(as_torch) == jmetrics.weights_fingerprint(tree)
    assert tmetrics.weights_fingerprint({"a": {"w": np.zeros((2, 3), np.float32)}, "b": tree["b"]}) != \
        tmetrics.weights_fingerprint(tree)


# ---------------------------------------------------------------- PPL
def ppl_draws(rng, n_batches: int, b: int, d: int) -> list:
    """The JAX ppl()'s draws in the port's order: per batch W's z [2b, d],
    then t [b, 1]."""
    out = []
    for _ in range(n_batches):
        rng, key = jax.random.split(rng)
        k1, k2 = jax.random.split(key)
        out += [jax.random.normal(k1, (2 * b, d)), jax.random.uniform(k2, (b, 1))]
    return out


@pytest.mark.parametrize("eps,rtol", [(1e-2, 1e-5), (1e-4, 1e-3)])
def test_ppl_function_matches_jax(eps, rtol):
    """One shared deterministic sampler at 512^2 (resized to 256^2 before
    the distance, antialiased in both) fed the same draws: z -> w is the
    identity and the images a smooth function of w. Each package lerps the
    pair and renders it in fp32 with its own rounding (XLA fuses the lerp and
    tanh, PyTorch does not): one ulp of a pixel, 6e-8, against a pair that
    differs by eps. At eps 1e-2 that is within 1e-5 relative; at the
    metric's eps 1e-4 each distance moves by up to 7e-4 (both packages
    against a float64 evaluation), so the mean is held to 1e-3."""
    D, B, N, RES = 8, 4, 12, 512
    base = np.linspace(-1, 1, RES, dtype=np.float32)
    grid = np.tanh(base[:, None] * base[None, :])[None, None]

    def synth_j(w):
        return jnp.tanh(w[:, :3, None, None] * jnp.asarray(grid) + w[:, 3:6, None, None] * 0.3)

    def synth_t(w):
        return torch.tanh(w[:, :3, None, None] * torch.from_numpy(grid) + w[:, 3:6, None, None] * 0.3)

    def dist_j(a, b):
        return jnp.mean(jnp.square(a - b), axis=(1, 2, 3))

    def dist_t(a, b):
        return (a - b).square().mean(dim=(1, 2, 3))

    rng = jax.random.PRNGKey(11)
    want = jmetrics.ppl(synth_j, lambda k, n: jax.random.normal(k, (n, D)), dist_j, n_sample=N, batch_size=B,
                        eps=eps, rng=rng)
    got = tmetrics.ppl(synth_t, lambda draws, n: draws.normal(n, D), dist_t, n_sample=N, batch_size=B, eps=eps,
                       draws=Replay(ppl_draws(rng, 3, B, D)))
    assert got == pytest.approx(want, rel=rtol)


def test_ppl_of_a_generator_matches_jax(ckpt):
    """End to end through each package's own 32^2 generator, fed the same
    draws, with the multi-scale L2 distance. A PPL divides each image
    difference by eps^2 = 1e-8: two fp32 conv libraries render the lerped
    pair with independent rounding of ~1e-6 per pixel on a difference of
    ~1e-4, so each distance moves by about 1 % and the mean of 16 by about
    1 % / sqrt(16). Held to 2e-2 relative; the cropped variant too."""
    jg, jv = jax_load_generator(ckpt)
    tg = load_generator(ckpt, device="cpu")

    def map_j(k, n):
        return jg.apply(jv, jax.random.normal(k, (n, 512)), method=JaxGenerator.get_latent)

    def synth_j(w):
        return jg.apply(jv, jnp.repeat(w[:, None], jg.n_latent, axis=1), input_is_latent=True, randomize_noise=False)[0]

    def dist_j(a, b):
        return sum(jnp.mean(jnp.square(a[:, :, ::s, ::s] - b[:, :, ::s, ::s]), axis=(1, 2, 3)) for s in (1, 2, 4))

    def map_t(draws, n):
        return tg.get_latent(draws.normal(n, 512))

    def synth_t(w):
        return tg(w[:, None].repeat(1, tg.n_latent, 1), input_is_latent=True, randomize_noise=False)[0]

    for crop in (False, True):
        rng = jax.random.PRNGKey(2)
        want = jmetrics.ppl(synth_j, map_j, dist_j, n_sample=16, batch_size=8, crop=crop, rng=rng)
        got = tmetrics.ppl(synth_t, map_t, tcli.multiscale_l2, n_sample=16, batch_size=8, crop=crop,
                           draws=Replay(ppl_draws(rng, 2, 8, 512)))
        assert got == pytest.approx(want, rel=2e-2) and want > 0

"""maua_tpu_torch.reactive against maua_tpu.reactive on the CPU: latent
timelines, perlin and reactive noise (fed the JAX package's own random draws,
recomputed here with the same jax.random calls), every bend transform at
1e-5 (translate on a non-square 4x8 activation, whose reflect pad exceeds
it), rewrites_for_batch, and generate_latents with the JAX z."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maua_tpu.reactive as jre
import maua_tpu_torch.audio as tar
import maua_tpu_torch.reactive as tre
from maua_tpu.io import generator_state_dict_to_torch
from maua_tpu.models import Generator as JaxGenerator

jbend, jnoise = (importlib.import_module(f"maua_tpu.reactive.{m}") for m in ("bend", "noise"))
tbend, tnoise, tlatent = (importlib.import_module(f"maua_tpu_torch.reactive.{m}") for m in ("bend", "noise", "latent"))


@pytest.fixture(autouse=True)
def cpu():
    tar.set_device("cpu")
    yield
    tar.set_device(None)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, atol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= atol, f"max abs {err} > {atol}"


def rnd(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------- latents
def test_chroma_weight_latents_matches_jax():
    chroma, lat = np.abs(rnd(20, 6)), rnd(6, 4, 8, seed=1)
    close(tre.chroma_weight_latents(t(chroma), t(lat)), jre.chroma_weight_latents(chroma, lat), 1e-5)
    assert tre.chroma_weight_latents(chroma, lat).device.type == "cpu"  # numpy in: the default device


@pytest.mark.parametrize("loop", [True, False])
def test_slerp_loops_matches_jax(loop):
    sel = rnd(4, 3, 16)
    for n_frames, n_loops, smoothing in ((40, 2, 1), (37, 1, 3)):
        got = tre.slerp_loops(t(sel), n_frames, n_loops, smoothing, loop, n_latent=5)
        close(got, jre.slerp_loops(sel, n_frames, n_loops, smoothing, loop, n_latent=5), 1e-5)
    np.testing.assert_allclose(tre.slerp(0.3, sel[0, 0], sel[1, 0]), jre.slerp(0.3, sel[0, 0], sel[1, 0]))


@pytest.mark.parametrize("loop", [True, False])
def test_spline_loops_matches_jax(loop):
    sel = rnd(5, 2, 8)
    for n_frames, n_loops in ((30, 2), (23, 1)):
        close(tre.spline_loops(t(sel), n_frames, n_loops, loop), jre.spline_loops(sel, n_frames, n_loops, loop), 1e-5)


def test_wrapping_slice_matches_jax():
    x = rnd(7, 3)
    for start, length in ((5, 4), (0, 7), (12, 9)):
        close(tre.wrapping_slice(t(x), start, length), jre.wrapping_slice(x, start, length), 0)
        np.testing.assert_array_equal(tre.wrapping_slice(t(x), start, length, return_indices=True).numpy(),
                                      np.asarray(jre.wrapping_slice(x, start, length, return_indices=True)))
    close(tre.wrapping_slice(t(x[:1]), 3, 4), jre.wrapping_slice(x[:1], 3, 4), 0)


def test_save_and_load_latents(tmp_path):
    x = rnd(3, 4, 5)
    tre.save_latents(t(x), str(tmp_path / "l.npy"))
    np.testing.assert_array_equal(tre.load_latents(str(tmp_path / "l.npy")).numpy(), np.asarray(jre.load_latents(str(tmp_path / "l.npy"))))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    gen = JaxGenerator(size=16, style_dim=32, n_mlp=2, channel_max=32, constant_input=True)
    v = gen.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, jnp.zeros((1, 32)))
    sd = generator_state_dict_to_torch(v, gen)
    path = tmp_path_factory.mktemp("ckpt") / "g.pt"
    torch.save({"g_ema": {k: torch.from_numpy(np.array(a)) for k, a in sd.items()}}, path)
    return str(path)


def test_generate_latents_matches_jax_with_the_same_z(checkpoint):
    want = np.asarray(jre.generate_latents(5, checkpoint, G_res=16, latent_dim=32, n_mlp=2, seed=3))
    zs = t(jax.random.normal(jax.random.PRNGKey(3), (5, 32)))
    close(tlatent._map_latents(checkpoint, zs, 16, False, 2, 2), want, 1e-5)
    own = tre.generate_latents(5, checkpoint, G_res=16, latent_dim=32, n_mlp=2, seed=3, device="cpu")
    assert own.shape == want.shape and torch.equal(own, tre.generate_latents(5, checkpoint, 16, latent_dim=32, n_mlp=2, seed=3, device="cpu"))


# ---------------------------------------------------------------- noise
def jax_angles(key, res):
    """The gradient angles jax's perlin_noise draws from `key`."""
    k1, k2 = jax.random.split(key)
    lattice = (res[0] + 1, res[1] + 1, res[2] + 1)
    theta = 2 * np.pi * jax.random.uniform(k1, lattice)
    phi = 2 * np.pi * jax.random.uniform(k2, lattice)
    return t(theta), t(phi)


@pytest.mark.parametrize("shape,res,tileable", [
    ((8, 8, 8), (2, 2, 2), (True, False, False)),
    ((12, 8, 16), (3, 2, 4), (True, True, True)),
    ((6, 4, 8), (1, 1, 2), (False, False, False)),
])
def test_perlin_matches_jax_with_its_draws(shape, res, tileable):
    key = jax.random.PRNGKey(sum(shape))
    want = jre.perlin_noise(key, shape, res, tileable)
    close(tnoise._perlin_from_angles(*jax_angles(key, res), shape, res, tileable), want, 1e-5)


def test_perlin_own_draws_and_shape_check():
    p = tre.perlin_noise(torch.Generator().manual_seed(0), (8, 8, 8), (2, 2, 2))
    assert p.shape == (8, 8, 8) and bool(torch.isfinite(p).all()) and float(p.std()) > 0
    assert torch.equal(p[0], tre.perlin_noise(0, (8, 8, 8), (2, 2, 2))[0])  # an int seeds a CPU generator here
    with pytest.raises(ValueError, match="multiple"):
        tre.perlin_noise(0, (7, 8, 8), (2, 2, 2))


@pytest.mark.parametrize("n_frames,h,w,periods", [(10, 8, 8, 4), (9, 4, 8, 3)])
def test_looping_perlin_matches_jax_with_its_draws(n_frames, h, w, periods, monkeypatch):
    key = jax.random.PRNGKey(7)
    monkeypatch.setattr(tnoise, "perlin_noise", lambda rng, shape, res, tileable: tnoise._perlin_from_angles(
        *jax_angles(key, res), shape, res, tileable))
    close(tre.looping_perlin(None, n_frames, h, w, periods), jre.looping_perlin(key, n_frames, h, w, periods), 1e-5)


def test_reactive_noise_matches_jax_with_its_draws():
    key = jax.random.PRNGKey(4)
    env = np.linspace(0, 1, 30).astype(np.float32)
    k1, k2 = jax.random.split(key)
    base, react = (t(jax.random.normal(k, (30, 1, 4, 8))) for k in (k1, k2))
    want = jre.reactive_noise(key, jnp.asarray(env), 4, 8, base_sigma=6.0, react_sigma=1.0)
    close(tnoise._reactive_noise_from(base, react, t(env), 6.0, 1.0), want, 1e-5)
    assert tre.reactive_noise(0, t(env), 4, 8).shape == (30, 1, 4, 8)


# ---------------------------------------------------------------- bends
def apply(bend_t, bend_j, x, mod):
    got = bend_t.transform(t(x), None if mod is None else t(mod))
    want = bend_j.transform(jnp.asarray(x), None if mod is None else jnp.asarray(mod))
    return got, want


@pytest.mark.parametrize("shape", [(2, 3, 4, 8), (2, 2, 8, 8)], ids=["4x8", "8x8"])
@pytest.mark.parametrize("kind", ["translate", "translate_noise", "zoom", "rotate", "noise", "noise_mod"])
def test_bends_match_jax(shape, kind):
    x = rnd(*shape)
    b, c, h, w = shape
    mod = {"translate": np.array([0.0, 0.37], np.float32), "translate_noise": np.array([0.5, 1.0], np.float32),
           "zoom": np.array([0.6, 1.7], np.float32), "rotate": np.array([15.0, -100.0], np.float32),
           "noise": None, "noise_mod": np.array([0.25, 2.0], np.float32)}[kind]
    if kind.startswith("translate"):
        noise = rnd(1, 1, h, 5 * w, seed=2) if kind == "translate_noise" else None
        pair = tre.translate_bend(4, t(mod), None if noise is None else t(noise)), jre.translate_bend(4, mod, noise)
    elif kind == "zoom":
        pair = tre.zoom_bend(2, t(mod)), jre.zoom_bend(2, mod)
    elif kind == "rotate":
        pair = tre.rotate_bend(2, t(mod)), jre.rotate_bend(2, mod)
    else:
        noise = rnd(1, 1, h, w, seed=3)
        pair = tre.add_noise_bend(1, t(noise), None if mod is None else t(mod)), jre.add_noise_bend(1, noise, mod)
    got, want = apply(*pair, x, mod)
    close(got, want, 1e-5)
    assert got.dtype == torch.float32
    if kind in ("translate", "zoom", "rotate"):  # no modulation: identity geometry
        got0, want0 = apply(*pair, x, None)
        close(got0, want0, 1e-5)


@pytest.mark.parametrize("mode", ["edge", "reflect", "symmetric", "wrap", "constant"])
def test_pad_bend_matches_jax(mode):
    x = rnd(1, 2, 4, 4)
    for pad in ((2, 2, 0, 0), (5, 1, 4, 6)):
        got, want = apply(tre.pad_bend(0, pad, mode), jre.pad_bend(0, pad, mode), x, None)
        close(got, want, 0)


def test_bilinear_gather_matches_jax():
    img = rnd(2, 3, 5, 7)
    px = np.random.default_rng(1).uniform(-2, 9, (2, 4, 6)).astype(np.float32)
    py = np.random.default_rng(2).uniform(-2, 7, (2, 4, 6)).astype(np.float32)
    from maua_tpu_torch.ops.gather import bilinear_gather

    close(bilinear_gather(t(img), t(px), t(py)), jbend._bilinear_gather(jnp.asarray(img), jnp.asarray(px), jnp.asarray(py)), 1e-5)


def test_print_bend_and_bends_for_batch(capsys):
    x = rnd(2, 1, 4, 4)
    out = tre.print_bend(3).transform(t(x), None)
    assert torch.equal(out, t(x)) and "bend[3] shape=(2, 1, 4, 4)" in capsys.readouterr().out
    mod = np.linspace(0, 1, 6).astype(np.float32)
    bends_t = [tre.translate_bend(2, t(mod)), tre.pad_bend(0)]
    bends_j = [jre.translate_bend(2, mod), jre.pad_bend(0)]
    pairs_t, pairs_j = tre.bends_for_batch(bends_t, 2, 4), jre.bends_for_batch(bends_j, 2, 4)
    assert [p[0] for p in pairs_t] == [p[0] for p in pairs_j] == [2, 0]
    for (_, ft), (_, fj) in zip(pairs_t, pairs_j):
        close(ft(t(x)), fj(jnp.asarray(x)), 1e-5)


# ---------------------------------------------------------------- rewrites
def test_rewrites_for_batch_matches_jax():
    w = rnd(3, 4)
    mod = np.linspace(0.5, 2.0, 8).astype(np.float32)

    def transform(weight, m):  # jnp and torch alike
        return weight * m.mean()

    params_t = {"convs.1.conv.weight": t(w), "style.1.bias": t(w[0])}
    params_j = {"convs_1": {"conv": {"weight": jnp.asarray(w)}}, "style_1": {"bias": jnp.asarray(w[0])}}
    got = tre.rewrites_for_batch(params_t, [tre.Rewrite("convs.1.conv.weight", transform, t(mod))], 2, 6)
    want = jre.rewrites_for_batch(params_j, [jre.Rewrite("convs_1/conv/weight", transform, mod)], 2, 6)
    close(got["convs.1.conv.weight"], want["convs_1"]["conv"]["weight"], 1e-6)
    assert torch.equal(got["style.1.bias"], params_t["style.1.bias"])
    assert torch.equal(params_t["convs.1.conv.weight"], t(w))  # the original is untouched
    assert tre.rewrites_for_batch(params_t, [], 0, 2) is params_t

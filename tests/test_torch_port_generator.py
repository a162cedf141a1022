"""maua_tpu_torch's Generator against maua_tpu's, on the CPU in fp32.

A narrow JAX Generator (size 32, channel_max 32, n_mlp 2), with constant
input and with LatentInput (noconst), is initialised, its zero-initialised
biases, noise weights and noise buffers are filled from a numpy seed, and its
weights are carried across with `generator_state_dict_from_jax`. Both get the
same numpy inputs with randomize_noise=False and an explicit noise list with
some None entries (which take the stored buffers). Images agree to 1e-4 max
abs: the two frameworks sum convolutions in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from maua_tpu.io import infer_generator_config as jax_infer_generator_config
from maua_tpu.io import load_generator as jax_load_generator
from maua_tpu.models import Generator as JaxGenerator
from maua_tpu.models import channel_map as jax_channel_map
from maua_tpu.models import noise_shapes as jax_noise_shapes
from maua_tpu_torch.io import generator_state_dict_from_jax, infer_generator_config, load_generator
from maua_tpu_torch.models import Generator, channel_map, noise_shapes

CFG = dict(size=32, style_dim=64, n_mlp=2, channel_multiplier=2, channel_max=32)
B = 2
TOL = 1e-4


def _randomize(variables, seed):
    """Fill the zero-initialised leaves (biases, noise weights, buffers)."""
    rng = np.random.RandomState(seed)

    def leaf(a):
        a = np.asarray(a)
        return a + 0.2 * rng.randn(*a.shape).astype(np.float32)

    params = jax.tree_util.tree_map(leaf, variables["params"])
    buffers = {k: rng.randn(*np.shape(v)).astype(np.float32) for k, v in variables["buffers"].items()}
    return {"params": params, "buffers": buffers}


@pytest.fixture(scope="module")
def models():
    out = {}
    for const in (True, False):
        jg = JaxGenerator(constant_input=const, **CFG)
        v = jg.init(
            {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
            jnp.zeros((1, CFG["style_dim"])),
            randomize_noise=False,
        )
        v = _randomize(v, seed=int(const))
        sd = generator_state_dict_from_jax(v["params"], v["buffers"])
        tg = Generator(constant_input=const, **CFG)
        tg.load_state_dict(sd, strict=True)
        out[const] = (jg, v, tg.eval(), sd)
    return out


def _inputs(jg, seed=3):
    rng = np.random.RandomState(seed)
    d = CFG["style_dim"]
    n_latent = int(np.log2(CFG["size"])) * 2 - 2
    shapes = jax_noise_shapes(CFG["size"])
    return dict(
        z=rng.randn(B, d).astype(np.float32),
        z2=rng.randn(B, d).astype(np.float32),
        wplus=rng.randn(B, n_latent, d).astype(np.float32),
        tl=rng.randn(1, d).astype(np.float32),
        noise=[None if i % 3 == 1 else rng.randn(B, 1, s[2], s[3]).astype(np.float32) for i, s in enumerate(shapes)],
    )


def _call(inp, case):
    """(styles, kwargs) for a case, in numpy; bends are framework-neutral."""
    kw = dict(noise=inp["noise"], randomize_noise=False)
    if case == "z":
        return inp["z"], kw
    if case == "w_plus":
        return inp["wplus"], dict(kw, input_is_latent=True)
    if case == "mixing":
        return [inp["z"], inp["z2"]], dict(kw, inject_index=3)
    if case == "trunc_scalar":
        return inp["z"], dict(kw, truncation=0.7, truncation_latent=inp["tl"])
    if case == "trunc_tensor":
        return inp["z"], dict(kw, truncation=np.array([0.5, 0.9], np.float32), truncation_latent=inp["tl"])
    if case == "return_latents":
        return [inp["z"], inp["z2"]], dict(kw, return_latents=True, truncation=0.8, truncation_latent=inp["tl"])
    if case == "activation_maps":
        return inp["z"], dict(kw, return_activation_maps=True)
    if case == "bends":
        return inp["z"], dict(kw, bends=[(0, lambda x: x * 1.5), (3, lambda x: x + 0.1)])
    raise KeyError(case)


def _to(conv, v):
    if isinstance(v, np.ndarray):
        return conv(v)
    if isinstance(v, list):
        return [_to(conv, a) for a in v]
    return v


def _run_both(jg, jvars, tg, styles, kw):
    jkw = {k: _to(jnp.asarray, v) for k, v in kw.items()}
    tkw = {k: _to(torch.from_numpy, v) for k, v in kw.items()}
    j_img, j_extra = jg.apply(jvars, _to(jnp.asarray, styles), **jkw)
    with torch.no_grad():
        t_img, t_extra = tg(_to(torch.from_numpy, styles), **tkw)
    return (np.asarray(j_img), j_extra), (t_img.numpy(), t_extra)


CASES = ["z", "w_plus", "mixing", "trunc_scalar", "trunc_tensor", "return_latents", "activation_maps", "bends"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("const", [True, False], ids=["const", "noconst"])
def test_generator_matches_jax(models, const, case):
    jg, jvars, tg, _ = models[const]
    styles, kw = _call(_inputs(jg), case)
    (j_img, j_extra), (t_img, t_extra) = _run_both(jg, jvars, tg, styles, kw)
    assert t_img.shape == j_img.shape == (B, 3, CFG["size"], CFG["size"])
    np.testing.assert_allclose(t_img, j_img, rtol=0, atol=TOL)
    if case == "return_latents":
        np.testing.assert_allclose(t_extra.numpy(), np.asarray(j_extra), rtol=0, atol=TOL)
    elif case == "activation_maps":
        assert len(t_extra) == len(j_extra) == 2 * int(np.log2(CFG["size"])) - 3
        for t_map, j_map in zip(t_extra, j_extra):
            np.testing.assert_allclose(t_map.numpy(), np.asarray(j_map), rtol=0, atol=TOL)
    else:
        assert t_extra is None and j_extra is None


@pytest.mark.parametrize("const", [True, False], ids=["const", "noconst"])
def test_generator_min_rgb_size_matches_jax(models, const):
    _, jvars, _, sd = models[const]
    jg = JaxGenerator(constant_input=const, min_rgb_size=8, **CFG)
    tg = Generator(constant_input=const, min_rgb_size=8, **CFG)
    tg.load_state_dict(sd, strict=True)
    styles, kw = _call(_inputs(jg), "z")
    (j_img, _), (t_img, _) = _run_both(jg, jvars, tg.eval(), styles, kw)
    np.testing.assert_allclose(t_img, j_img, rtol=0, atol=TOL)


def test_truncation_without_latent_raises(models):
    tg = models[True][2]
    z = torch.randn(B, CFG["style_dim"])
    with pytest.raises(ValueError, match="truncation_latent"):
        tg(z, truncation=0.7)
    with pytest.raises(ValueError, match="truncation_latent"):
        tg(z, truncation=torch.tensor([0.5, 0.9]))


@pytest.mark.parametrize(
    "size,output_size,base_res_factor",
    [(1024, None, 1), (1024, 1920, 1), (1024, 1080, 1), (256, 256, 1.5)],
)
def test_noise_shapes_and_channel_map_match_jax(size, output_size, base_res_factor):
    assert noise_shapes(size, output_size, base_res_factor) == jax_noise_shapes(size, output_size, base_res_factor)
    for mult, cmax in ((2, 512), (1, 512), (2, 64)):
        assert channel_map(mult, cmax) == jax_channel_map(mult, cmax)


@pytest.fixture(scope="module")
def checkpoint(models, tmp_path_factory):
    """A rosinality .pt fabricated by the JAX package's own exporter."""
    from test_torch_ckpt import _flax_gen_to_torch_sd

    jg, jvars, _, _ = models[True]
    sd = _flax_gen_to_torch_sd(jvars, jg)
    path = tmp_path_factory.mktemp("ckpt") / "g.pt"
    torch.save({"g_ema": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}}, path)
    return str(path), sd


def test_load_generator_matches_jax(models, checkpoint):
    path, sd_np = checkpoint
    assert infer_generator_config({k: torch.from_numpy(v) for k, v in sd_np.items()}) == jax_infer_generator_config(sd_np)
    jg, jvars = jax_load_generator(path)
    tg = load_generator(path, device="cpu")
    assert tg.size == jg.size and tg.constant_input == jg.constant_input
    assert not tg.training and not any(p.requires_grad for p in tg.parameters())
    styles, kw = _call(_inputs(jg), "w_plus")
    (j_img, _), (t_img, _) = _run_both(jg, jvars, tg, styles, kw)
    np.testing.assert_allclose(t_img, j_img, rtol=0, atol=TOL)


def test_load_generator_widescreen_tiles_noise_like_jax(checkpoint):
    """output_size=1920 re-tiles the stored square noise buffers to the
    widescreen geometry; a layer-0 edge pad widens the 4x4 input to 4x8."""
    path, _ = checkpoint
    jg, jvars = jax_load_generator(path, output_size=1920)
    tg = load_generator(path, device="cpu", output_size=1920)
    for i, shape in enumerate(jax_noise_shapes(CFG["size"], 1920)):
        buf = getattr(tg.noises, f"noise_{i}")
        assert tuple(buf.shape) == shape
        np.testing.assert_array_equal(buf.numpy(), np.asarray(jvars["buffers"][f"noise_{i}"]))
    w = np.random.RandomState(5).randn(B, tg.n_latent, CFG["style_dim"]).astype(np.float32)
    j_img, _ = jg.apply(
        jvars, jnp.asarray(w), input_is_latent=True, randomize_noise=False,
        bends=[(0, lambda x: jnp.pad(x, ((0, 0), (0, 0), (0, 0), (2, 2)), mode="edge"))],
    )
    with torch.no_grad():
        t_img, _ = tg(
            torch.from_numpy(w), input_is_latent=True, randomize_noise=False,
            bends=[(0, lambda x: F.pad(x, (2, 2, 0, 0), mode="replicate"))],
        )
    assert t_img.shape == (B, 3, CFG["size"], 2 * CFG["size"])
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img), rtol=0, atol=TOL)


def test_load_generator_ignores_conflicting_arch_overrides(checkpoint):
    path, _ = checkpoint
    with pytest.warns(UserWarning, match="constant_input"):
        tg = load_generator(path, device="cpu", constant_input=False, size=32)
    assert tg.constant_input and tg.size == 32

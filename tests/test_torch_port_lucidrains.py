"""maua_tpu_torch's lucidrains models, losses, style mixing, DiffGrad and
trainer against maua_tpu's on the CPU, in fp32.

Weights are made by the port's modules from a torch seed, written into the
flax param tree of the JAX module (its structure from `jax.eval_shape` of the
module's init, no compile) and carried back into a fresh port module through
`io.lucidrains_state_dict_from_jax`, loaded strictly: the converter is held
to every key and layout. Inputs come from numpy seeds; JAX's random draws are
replayed in the port through `StyleDraw`s and a replaying `Draws`. The
Rezero gains start at 0 in both packages, which hides the attention path: the
tests set them to 0.5. Tolerances are stated per test; fp32 convolutions and
matrix products of two libraries differ by rounding, about 1e-6 of a
value.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maua_tpu.models import lucidrains as J
from maua_tpu.train import lucidrains_trainer as JT
from maua_tpu_torch.draws import Draws
from maua_tpu_torch.io import lucidrains_state_dict_from_jax
from maua_tpu_torch.models import lucidrains as T
from maua_tpu_torch.train import LucidrainsConfig, LucidrainsTrainer, NanException, diffgrad

REZERO = 0.5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs: the models are tiny, and
    with several test workers on the host, eight threads per worker made a
    3 s test take minutes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def flax_params(port: torch.nn.Module, jax_module, *init_args) -> dict:
    """The port module's weights as the JAX module's flax params (numpy)."""
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), *init_args)["params"]
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}

    def fill(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = fill(v, path + [k])
                continue
            t = sd[".".join(path + ["weight" if k == "kernel" else k])]
            if k == "kernel":
                t = t.T if t.ndim == 2 else t.transpose(2, 3, 1, 0)  # [out, in] -> [in, out]; OIHW -> HWIO
            if k == "rezero_g":
                t = np.float32(REZERO)
            assert t.shape == tuple(v.shape), (path, k, t.shape, v.shape)
            out[k] = np.array(t, dtype=np.float32)
        return out

    return fill(dict(shapes), [])


def carried(port_cls, params: dict, **kw) -> torch.nn.Module:
    """A fresh port module with the JAX params loaded through the converter."""
    m = port_cls(**kw)
    m.load_state_dict(lucidrains_state_dict_from_jax(params), strict=True)
    return m


def pair(port_cls, jax_cls, init_args, seed=0, **kw):
    torch.manual_seed(seed)
    params = flax_params(port_cls(**kw), jax_cls(**kw), *init_args)
    return carried(port_cls, params, **kw), params


def close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err <= rel, f"{what}: {err} of the largest value > {rel}"


def test_conv2dmod_matches_jax():
    """Modulated conv, demodulated and not: within 1e-5 of the largest value."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    style = rng.standard_normal((2, 4)).astype(np.float32)
    for demod, k in ((True, 3), (False, 1)):
        torch.manual_seed(1)
        params = flax_params(T.Conv2DMod(4, 6, k, demod), J.Conv2DMod(6, k, demod), x, style)
        port = carried(lambda: T.Conv2DMod(4, 6, k, demod), params)
        want = J.Conv2DMod(6, k, demod).apply({"params": params}, x, style)
        close(port(torch.from_numpy(x), torch.from_numpy(style)).detach(), want, 1e-5, f"demod={demod}")


def test_linear_attention_matches_jax():
    """Softmax of q over the key dim, of k over pixels, two contractions and
    the Rezero residual (gain 0.5): within 1e-5 of the largest value, on a
    non-square map."""
    x = np.random.default_rng(1).standard_normal((2, 8, 4, 6)).astype(np.float32)
    torch.manual_seed(2)
    port = T.LinearAttention(8, key_dim=4, heads=2)
    params = flax_params(port, J.LinearAttention(8, 4, 2), x)
    port = carried(lambda: T.LinearAttention(8, key_dim=4, heads=2), params)
    want = J.LinearAttention(8, 4, 2).apply({"params": params}, x)
    got = port(torch.from_numpy(x)).detach()
    close(got, want, 1e-5)
    close(got - torch.from_numpy(x), np.asarray(want) - x, 1e-4, "the attention branch alone")


def test_vector_quantize_matches_jax():
    """Inputs planted 0.02 from codes whose neighbours are far: the indices
    are the planted ones, the output (the codes, straight through) and the
    loss within 1e-6, the straight-through gradient of sum(out^2) within
    1e-6 (it is 2 out, as if the quantiser were the identity)."""
    rng = np.random.default_rng(3)
    torch.manual_seed(3)
    port = T.VectorQuantize(4, codebook_size=8)
    x0 = np.zeros((2, 4, 3, 5), np.float32)
    params = flax_params(port, J.VectorQuantize(4, 8), x0)
    codebook = params["codebook"]
    idx = rng.integers(0, 8, (2, 3, 5))
    flat = codebook[idx.reshape(-1)] + 0.02 * rng.standard_normal((30, 4)).astype(np.float32)
    d = ((flat[:, None] - codebook[None]) ** 2).sum(-1)
    gaps = np.sort(d, axis=1)
    assert (gaps[:, 1] - gaps[:, 0]).min() > 0.1  # the nearest code is well separated
    x = flat.reshape(2, 3, 5, 4).transpose(0, 3, 1, 2).copy()
    port = carried(lambda: T.VectorQuantize(4, codebook_size=8), params)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, loss = port(xt)
    (gx,) = torch.autograd.grad(out.square().sum(), xt)
    vq = J.VectorQuantize(4, 8)
    want, want_loss = vq.apply({"params": params}, x)
    want_g = jax.grad(lambda v: jnp.sum(vq.apply({"params": params}, v)[0] ** 2))(jnp.asarray(x))
    np.testing.assert_array_equal(port.nearest(torch.from_numpy(flat)).numpy(), idx.reshape(-1))
    close(out.detach(), want, 1e-6, "out")
    close(out.detach(), codebook[idx].transpose(0, 3, 1, 2), 1e-6, "codes")
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-6)
    close(gx, want_g, 1e-6, "straight-through gradient")


G_KW = dict(image_size=16, latent_dim=16, network_capacity=2, attn_layers=(2,))


@pytest.fixture(scope="module")
def gen_pair():
    rng = np.random.default_rng(4)
    n = int(np.log2(16) - 1)
    styles = rng.standard_normal((2, n, 16)).astype(np.float32)
    noise = rng.uniform(size=(2, 16, 16, 1)).astype(np.float32)
    port, params = pair(T.LucidrainsGenerator, J.LucidrainsGenerator, (styles, noise), seed=5, **G_KW)
    return port, params, styles, noise


def test_generator_with_attention_matches_jax(gen_pair):
    """G at 16^2 with linear attention at layer 2 (gain 0.5): the image within
    1e-5 of the largest value."""
    port, params, styles, noise = gen_pair
    want = jax.jit(J.LucidrainsGenerator(**G_KW).apply)({"params": params}, styles, noise)
    close(port(torch.from_numpy(styles), torch.from_numpy(noise)).detach(), want, 1e-5)


def test_generator_block_noise_swap_on_a_cropped_map():
    """The noise projection takes the crop [B, H, W, 1] as [B, F, W, H]: with a
    12 x 12 noise cropped to an 8 x 8 map and noise that varies along H
    alone, the port's block equals JAX's within 1e-5 and not the block
    given the noise transposed (the swap is real and kept)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    istyle = rng.standard_normal((2, 16)).astype(np.float32)
    along_h = rng.uniform(size=(2, 12, 1, 1)).astype(np.float32)
    inoise = np.broadcast_to(along_h, (2, 12, 12, 1)).copy()
    kw = dict(latent_dim=16, filters=6, upsample=True, upsample_rgb=False)
    torch.manual_seed(7)
    port = T.GeneratorBlock(input_channels=4, **kw)
    params = flax_params(port, J.GeneratorBlock(**kw), x, None, istyle, inoise)
    port = carried(lambda: T.GeneratorBlock(input_channels=4, **kw), params)
    want_x, want_rgb = J.GeneratorBlock(**kw).apply({"params": params}, x, None, istyle, inoise)
    got_x, got_rgb = port(torch.from_numpy(x), None, torch.from_numpy(istyle), torch.from_numpy(inoise))
    close(got_x.detach(), want_x, 1e-5, "x")
    close(got_rgb.detach(), want_rgb, 1e-5, "rgb")
    swapped, _ = port(torch.from_numpy(x), None, torch.from_numpy(istyle), torch.from_numpy(inoise.transpose(0, 2, 1, 3).copy()))
    assert np.abs(swapped.detach().numpy() - np.asarray(want_x)).max() > 1e-2


D_KW = dict(image_size=16, network_capacity=2, fq_layers=(1,), fq_dict_size=8, attn_layers=(2,))


@pytest.fixture(scope="module")
def disc_pair():
    x = np.random.default_rng(8).standard_normal((2, 3, 16, 16)).astype(np.float32)
    port, params = pair(T.LucidrainsDiscriminator, J.LucidrainsDiscriminator, (x,), seed=9, **D_KW)
    return port, params, x


def _fq_margin(port, x) -> float:
    """The smallest gap between the nearest and the second-nearest code over
    the pixels of D's fq layer, in float64 from the port's own features."""
    seen = {}
    hook = port.fq_0.register_forward_hook(lambda m, inp, out: seen.update(x=inp[0].detach()))
    port(torch.from_numpy(x))
    hook.remove()
    flat = seen["x"].permute(0, 2, 3, 1).reshape(-1, port.fq_0.dim).double()
    d = torch.cdist(flat, port.fq_0.codebook.detach().double()).square()
    top = d.topk(2, largest=False).values
    return float((top[:, 1] - top[:, 0]).min())


def test_discriminator_with_fq_and_attention_matches_jax(disc_pair):
    """D at 16^2 with fq at layer 1 (8 codes) and attention at layer 2: the
    logits and the quantize loss within 1e-5 (relative). The inputs keep the
    nearest code of every pixel at least 1e-4 ahead of the next (the squared
    distances are of order 1-10, rounded at about 1e-6), so that two
    libraries' rounding cannot pick other codes."""
    port, params, x = disc_pair
    assert _fq_margin(port, x) > 1e-4
    want, want_q = J.LucidrainsDiscriminator(**D_KW).apply({"params": params}, x)
    got, got_q = port(torch.from_numpy(x))
    close(got.detach(), want, 1e-5, "logits")
    np.testing.assert_allclose(float(got_q), float(want_q), rtol=1e-5)


def test_losses_and_gradient_penalty_match_jax(disc_pair):
    """The hinge losses (sign convention kept: relu(1 + real) + relu(1 - fake))
    exactly on hand-made logits and within 1e-6 on random ones; the gradient
    penalty within rtol 1e-5 and its gradient with respect to D's weights (a
    double backward through D) within 1e-4 of each tensor's largest."""
    assert float(T.hinge_d_loss(torch.tensor([-2.0, -1.5]), torch.tensor([2.0, 1.0]))) == 0.0
    assert float(T.hinge_g_loss(torch.tensor([2.0, 1.0]))) == 1.5
    rng = np.random.default_rng(10)
    real, fake = rng.standard_normal((2, 6)).astype(np.float32)
    np.testing.assert_allclose(float(T.hinge_d_loss(torch.from_numpy(real), torch.from_numpy(fake))),
                               float(J.hinge_d_loss(real, fake)), rtol=1e-6)
    port, params, x = disc_pair
    d = J.LucidrainsDiscriminator(**D_KW)
    want, want_g = jax.jit(jax.value_and_grad(lambda p: J.gradient_penalty(lambda im: d.apply({"params": p}, im), jnp.asarray(x))))(params)
    got = T.gradient_penalty(port, torch.from_numpy(x))
    grads = torch.autograd.grad(got, list(port.parameters()), allow_unused=True)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    want_sd = lucidrains_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, want_g))
    for (name, _), g in zip(port.named_parameters(), grads):
        close(torch.zeros_like(want_sd[name]) if g is None else g, want_sd[name], 1e-4, name)


def test_mixed_styles_matches_jax_draws():
    """mixed_styles on JAX's own draws (z1, z2, mix, tt from the four keys of
    its rng): within 1e-6 of the largest value; draw_styles from a
    torch.Generator and from a Draws object gives the shapes, types and the
    range [1, num_layers) of tt."""
    rng = jax.random.PRNGKey(11)
    torch.manual_seed(12)
    port = T.StyleVectorizer(emb=16, depth=2)
    params = flax_params(port, J.StyleVectorizer(16, 2), np.zeros((1, 16), np.float32))
    port = carried(lambda: T.StyleVectorizer(emb=16, depth=2), params)
    sv = J.StyleVectorizer(16, 2)
    want = J.mixed_styles(rng, lambda z: sv.apply({"params": params}, z), 8, 5, 16, 0.5)
    k1, k2, k3, k4 = jax.random.split(rng, 4)
    draw = T.StyleDraw(*(torch.from_numpy(np.array(a)) for a in (
        jax.random.normal(k1, (8, 16)), jax.random.normal(k2, (8, 16)), jax.random.bernoulli(k3, 0.5, (8,)),
        jax.random.randint(k4, (8,), 1, 5))))
    got = T.mixed_styles(draw, port, 8, 5, 16, 0.5).detach()
    close(got, want, 1e-6)
    assert 0 < int(draw.mix.sum()) < 8  # both kinds of sample are in the batch
    for source in (torch.Generator().manual_seed(0), Draws(0, "cpu")):
        own = T.draw_styles(source, 64, 5, 16, 0.5)
        assert own.z1.shape == own.z2.shape == (64, 16) and own.mix.dtype == torch.bool and own.mix.shape == (64,)
        assert own.tt.dtype == torch.int64 and sorted(set(own.tt.tolist())) == [1, 2, 3, 4]


def test_diffgrad_matches_optax_over_three_updates():
    """DiffGrad over three different gradients: each update and the weights
    within 1e-6 of the largest value of the JAX package's optax transform
    (fp32 bias corrections, the friction of the previous gradient)."""
    rng = np.random.default_rng(13)
    w0 = np.zeros((3, 5), np.float32)  # the weights stay near the updates' size, so their differences are exact enough
    grads = [rng.standard_normal((3, 5)).astype(np.float32) * s for s in (1.0, 0.3, 2.0)]
    opt = JT.diffgrad(1e-2, 0.5, 0.9)
    params, state = {"w": jnp.asarray(w0)}, None
    state = opt.init(params)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    topt = diffgrad([p], 1e-2)
    for g in grads:
        upd, state = opt.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, upd)
        before = p.detach().clone()
        p.grad = torch.from_numpy(g)
        topt.step()
        close(p.detach() - before, upd["w"], 1e-5, "update")
        close(p.detach(), params["w"], 1e-6, "weights")


TINY = LucidrainsConfig(image_size=16, latent_dim=16, style_depth=2, network_capacity=2, batch_size=2,
                        gradient_accumulate_every=2, fq_layers=(1,), fq_dict_size=8, attn_layers=(2,))


def test_trainer_nan_recovery_and_checkpoints(tmp_path):
    """Two steps with a checkpoint after each (save_every 1; the first step
    also saves model_0.pt, the state before it): finite metrics, the GP at
    step 0, G's weights moved, the EMA copies untouched below ema_start. NaN
    reals raise NanException and restore the step-2 checkpoint; save / load
    is a round trip of the whole state. In the first interval of a fresh run
    (save_every 1000) NaN reals restore model_0.pt, the initial state."""
    tr = LucidrainsTrainer(TINY, models_dir=str(tmp_path), save_every=1, device="cpu")
    g0 = [p.detach().clone() for p in tr.state.g.parameters()]
    real = torch.from_numpy(np.random.default_rng(14).uniform(-1, 1, (2, 2, 3, 16, 16)).astype(np.float32))
    m1, m2 = tr.train(real), tr.train(real)
    assert all(np.isfinite(v) for m in (m1, m2) for v in m.values())
    assert m1["R1"] > 0 and m2["R1"] == 0 and m1["Path Length"] > 0
    assert tr.state.step == 2 and sorted(p.name for p in (tmp_path / "default").iterdir()) == ["model_0.pt", "model_1.pt", "model_2.pt"]
    assert any(not torch.equal(a, b) for a, b in zip(g0, tr.state.g.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(g0, tr.state.ge.parameters()))
    saved = {k: v.clone() for k, v in tr.state.d.state_dict().items()}
    bad = real.clone()
    bad[0, 0] = float("nan")
    with pytest.raises(NanException):
        tr.train(bad)
    assert tr.state.step == 2
    assert all(torch.equal(saved[k], v) for k, v in tr.state.d.state_dict().items())
    tr.train(real)
    tr.load(2)
    assert tr.state.step == 2 and all(torch.equal(saved[k], v) for k, v in tr.state.d.state_dict().items())
    assert tr.state.d_opt.state_dict()["state"][0]["step"] == 2

    fresh = LucidrainsTrainer(TINY, models_dir=str(tmp_path), name="fresh", save_every=1000, device="cpu")
    before = {k: v.clone() for k, v in fresh.state.g.state_dict().items()}
    with pytest.raises(NanException):
        fresh.train(bad)
    assert fresh.state.step == 0 and not fresh.state.g_opt.state
    assert sorted(p.name for p in (tmp_path / "fresh").iterdir()) == ["model_0.pt"]
    assert all(torch.equal(before[k], v) for k, v in fresh.state.g.state_dict().items())


class Replay:
    """A Draws-like object that serves precomputed arrays in order."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def normal(self, *shape):
        return self._next(shape)

    uniform = normal

    def _next(self, shape):
        a = torch.from_numpy(np.array(self.arrays.pop(0)))
        assert tuple(a.shape) == shape, (a.shape, shape)
        return a


def test_trainer_generate_matches_jax(tmp_path):
    """generate(n=2, trunc_psi=0.6) from the EMA copies on JAX's draws (z, the
    2000 z of the mean W, the noise): within 1e-5 of the largest value."""
    cfg = TINY._replace(attn_layers=(), fq_layers=())
    tr = LucidrainsTrainer(cfg, models_dir=str(tmp_path), device="cpu")
    n = int(np.log2(16) - 1)
    s_params = flax_params(tr.state.se, J.StyleVectorizer(16, 2), np.zeros((1, 16), np.float32))
    g_params = flax_params(tr.state.ge, J.LucidrainsGenerator(16, 16, 2),
                           np.zeros((1, n, 16), np.float32), np.zeros((1, 16, 16, 1), np.float32))
    jcfg = JT.LucidrainsConfig(**cfg._asdict())
    holder = types.SimpleNamespace(cfg=jcfg, state=types.SimpleNamespace(se_params=s_params, ge_params=g_params))
    rng = jax.random.PRNGKey(15)
    want = JT.LucidrainsTrainer.generate(holder, rng, n=2, trunc_psi=0.6)
    k1, k2, k3 = jax.random.split(rng, 3)
    draws = Replay([jax.random.normal(k1, (2, 16)), jax.random.normal(k2, (2000, 16)), jax.random.uniform(k3, (2, 16, 16, 1))])
    got = tr.generate(n=2, trunc_psi=0.6, draws=draws)
    assert got.shape == (2, 3, 16, 16) and got.dtype == np.float32
    close(got, want, 1e-5)

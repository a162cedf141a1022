"""maua_tpu_torch's training path against maua_tpu's, on the CPU in fp32: the
fused bias + leaky-ReLU autograd Functions (first and second order) against
the Pallas kernel in interpret mode, the Discriminator, minibatch stddev, the
losses, the D and R1 phases with their gradients, Adam, EMA and lookahead.
The G and path-length phases and the step's options are in
test_torch_port_train_step.py, which shares the set-up below.

Set-up: one narrow model held by both packages, and the JAX package's own
random draws carried across to the port.

The port's state is built first (size 16, channel_max 32, latent_dim 32,
batch 4, on the CPU); its zero-initialised biases and noise weights are
filled from a numpy seed. Its state dicts go through the JAX package's own
rosinality converters into a JAX `GANTrainState`, so both sides start from
the same weights. The JAX phases draw from `jax.random` keys; the helpers
below repeat those draws (z1, z2, mixing mask, inject index, image noise)
with the same keys, and read the per-layer noise the JAX Generator draws by
running it with zeroed conv weights and unit noise weights, which makes each
NoiseInjection output exactly its noise. The JAX optimizers have b1 = 0, so
the first moment of a fresh Adam state after one update is exactly the
gradient: that is how the JAX side's gradients are read. With ADA, the
augmentation variates are rebuilt from the JAX phases' keys as well
(`test_torch_port_augment.jax_augment_draw`).
"""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from maua_tpu.io.torch_ckpt import discriminator_variables_from_torch, generator_variables_from_torch
from maua_tpu.models import Discriminator as JaxDiscriminator
from maua_tpu.models import Generator as JaxGenerator
from maua_tpu.models.blocks import NoiseInjection
from maua_tpu.train.step import GANTrainState, _reg_adjusted_adam
from maua_tpu.train.step import make_train_config as jax_make_train_config
from maua_tpu_torch.io import discriminator_state_dict_from_jax, generator_state_dict_from_jax
from maua_tpu_torch.train import MixDraw, PathDraw, init_train_state, make_train_config
from maua_tpu_torch.train.step import fused_d_pass
from test_torch_port_augment import jax_augment_draw

CFG = dict(size=16, batch_size=4, channel_max=32, latent_dim=32, augment=False, lookahead=False)


def port_state(seed: int = 0, **over):
    """(config, state) of the port on the CPU, biases and noise weights filled."""
    cfg = make_train_config(**{**CFG, **over})
    st = init_train_state(cfg, seed=seed, device="cpu")
    rng = np.random.RandomState(seed + 10)
    with torch.no_grad():
        for name, p in itertools.chain(st.g.named_parameters(), st.d.named_parameters()):
            if name.endswith("bias") or name.endswith("noise.weight"):
                p.add_(torch.from_numpy(0.2 * rng.randn(*p.shape).astype(np.float32)))
        st.g_ema.load_state_dict(st.g.state_dict())
    return cfg, st


class JaxSide:
    """The JAX package's modules, config and a GANTrainState holding the port
    state's weights."""

    def __init__(self, st, **over):
        kw = {**CFG, **over}
        self.cfg = jcfg = jax_make_train_config(**kw)
        self.gen = JaxGenerator(
            size=jcfg.size, style_dim=jcfg.latent_dim, channel_multiplier=jcfg.channel_multiplier,
            channel_max=jcfg.channel_max, constant_input=jcfg.constant_input, dtype=jnp.float32, s2d_min_res=0,
        )
        self.disc = JaxDiscriminator(
            size=jcfg.size, channel_multiplier=jcfg.channel_multiplier, channel_max=jcfg.channel_max,
            dtype=jnp.float32, s2d_min_res=0,
        )
        # copies both ways: a JAX array may alias the numpy buffer it was made
        # from, and the port updates its parameters in place
        gv = generator_variables_from_torch({k: v.numpy().copy() for k, v in st.g.state_dict().items()})
        dv = discriminator_variables_from_torch({k: v.numpy().copy() for k, v in st.d.state_dict().items()})
        self.buffers = gv["buffers"]
        self.n_latent = int(np.log2(jcfg.size)) * 2 - 2
        self.state = GANTrainState(
            step=jnp.zeros((), jnp.int32),
            g_params=gv["params"],
            d_params=dv["params"],
            g_ema_params=gv["params"],
            g_buffers=gv["buffers"],
            g_opt_state=_reg_adjusted_adam(jcfg.lr, jcfg.g_reg_every).init(gv["params"]),
            d_opt_state=_reg_adjusted_adam(jcfg.lr, jcfg.d_reg_every).init((dv["params"], None)),
            lookahead=None,
            cl_head=None,
            mean_path_length=jnp.zeros(()),
            ada_p=jnp.asarray(jcfg.augment_p, jnp.float32),
            ada_signs=jnp.zeros(()),
            ada_n=jnp.zeros(()),
            cl_state=None,
        )

    def layer_noise(self, key, batch: int) -> list[np.ndarray]:
        """The per-layer noise the JAX Generator draws from `key`."""

        def fix(path, leaf):
            names = [getattr(k, "key", None) for k in path]
            if names[-2:] == ["conv", "weight"] and (names[0] == "conv1" or names[0].startswith("convs_")):
                return jnp.zeros_like(leaf)
            if names[-2:] == ["noise", "weight"]:
                return jnp.ones_like(leaf)
            return leaf

        params = jax.tree_util.tree_map_with_path(fix, self.state.g_params)
        _, st = self.gen.apply(
            {"params": params, "buffers": self.buffers},
            jnp.zeros((batch, self.n_latent, self.cfg.latent_dim)),
            input_is_latent=True,
            randomize_noise=True,
            rngs={"noise": key},
            capture_intermediates=lambda mdl, _: isinstance(mdl, NoiseInjection),
            mutable=["intermediates"],
        )
        inter = st["intermediates"]
        n_convs = sum(1 for k in inter if k.startswith("convs_"))
        names = ["conv1"] + [f"convs_{i}" for i in range(n_convs)]
        return [np.array(inter[n]["noise"]["__call__"][0]) for n in names]

    def mix_draw(self, kw, kn, batch: int, img_key=None):
        """The port's MixDraw (or PathDraw with `img_key`) of the JAX draws
        from the keys `kw` (latents, mixing) and `kn` (noise)."""
        kz1, kz2, kmix, kidx = jax.random.split(kw, 4)
        t = lambda a: torch.from_numpy(np.array(a))
        z1 = t(jax.random.normal(kz1, (batch, self.cfg.latent_dim)))
        z2 = t(jax.random.normal(kz2, (batch, self.cfg.latent_dim)))
        mix = t(jax.random.bernoulli(kmix, self.cfg.mixing_prob, (batch,)))
        inject = t(jax.random.randint(kidx, (batch,), 1, self.n_latent)).long()
        noise = [torch.from_numpy(n) for n in self.layer_noise(kn, batch)]
        if img_key is None:
            return MixDraw(z1, z2, mix, inject, noise)
        img = t(jax.random.normal(img_key, (batch, 3, self.cfg.size, self.cfg.size)))
        return PathDraw(z1, z2, mix, inject, noise, img_noise=img)

    def d_draws(self, rng) -> list:
        """With ADA: one [2B] augmentation draw for the fused fake/real pass
        (key ka1), else one [B] draw for the fakes (ka1) and one for the
        reals (ka2)."""
        out, b = [], self.cfg.batch_size
        for key in jax.random.split(rng, self.cfg.num_accumulate):
            kw, kn, ka1, ka2 = jax.random.split(key, 4)
            draw = self.mix_draw(kw, kn, b)
            if self.cfg.augment:
                fused = fused_d_pass(self.cfg, self.disc.stddev_group)
                draw.aug = (jax_augment_draw(ka1, 2 * b),) if fused else (jax_augment_draw(ka1, b), jax_augment_draw(ka2, b))
            out.append(draw)
        return out

    def g_draws(self, rng) -> list:
        out = []
        for key in jax.random.split(rng, self.cfg.num_accumulate):
            kw, kn, ka = jax.random.split(key, 3)
            draw = self.mix_draw(kw, kn, self.cfg.batch_size)
            if self.cfg.augment:
                draw.aug = (jax_augment_draw(ka, self.cfg.batch_size),)
            out.append(draw)
        return out

    def path_draws(self, rng) -> list:
        reg_k = max(1, self.cfg.reg_chunks)
        pb = max(1, self.cfg.batch_size // max(self.cfg.path_batch_shrink, 1) // reg_k)
        out = []
        for key in jax.random.split(rng, self.cfg.num_accumulate * reg_k):
            kw, kn, kimg = jax.random.split(key, 3)
            out.append(self.mix_draw(kw, kn, pb, img_key=kimg))
        return out

    def add_contrastive(self, st) -> None:
        """The port state's projection head, key encoder and queue, carried
        across; D's Adam state spans (D, head) as in the JAX package."""
        from maua_tpu.train.contrastive import ContrastiveState

        np_ = lambda v: jnp.asarray(v.detach().numpy().copy())  # noqa: E731
        head = {k: np_(v) for k, v in st.cl_head.state_dict().items()}
        cl, cl_j = st.cl_state, None
        if cl is not None:
            key = None if cl.key_d is None else discriminator_variables_from_torch(
                {k: v.numpy().copy() for k, v in cl.key_d.state_dict().items()})["params"]
            cl_j = ContrastiveState(key, np_(cl.queue), jnp.asarray(int(cl.queue_ptr), jnp.int32),
                                    jnp.asarray(int(cl.queue_filled), jnp.int32))
        self.state = self.state.replace(
            cl_head=head, cl_state=cl_j,
            d_opt_state=_reg_adjusted_adam(self.cfg.lr, self.cfg.d_reg_every).init((self.state.d_params, head)),
        )

    def grads_d(self, new_state) -> dict[str, np.ndarray]:
        mu = new_state.d_opt_state[0].mu[0]
        return {k: v.numpy() for k, v in discriminator_state_dict_from_jax(mu).items() if not k.endswith("kernel")}

    def grads_g(self, new_state) -> dict[str, np.ndarray]:
        mu = new_state.g_opt_state[0].mu
        return {k: v.numpy() for k, v in generator_state_dict_from_jax(mu, {}).items() if not k.endswith("kernel")}


def port_grads(module: torch.nn.Module, grads) -> dict[str, np.ndarray]:
    return {n: g.detach().numpy() for (n, _), g in zip(module.named_parameters(), grads)}


def assert_grads_close(got: dict, want: dict, rtol: float, floor: float = 1e-6) -> None:
    """Per tensor: max |got - want| <= rtol * max |want| + floor."""
    assert sorted(got) == sorted(want)
    for name in want:
        a, b = got[name], want[name]
        assert a.shape == b.shape, name
        err, scale = np.abs(a - b).max(), np.abs(b).max()
        assert err <= rtol * scale + floor, f"{name}: max abs err {err:.3g} vs max abs {scale:.3g}"


# ---------------------------------------------------------------- fused act
import math  # noqa: E402

import pytest  # noqa: E402

from maua_tpu.ops.fused_act import fused_leaky_relu as jax_fused_leaky_relu  # noqa: E402
from maua_tpu.ops.pallas_act import fused_leaky_relu_pallas  # noqa: E402
from maua_tpu_torch.ops.fused_act import (  # noqa: E402
    FusedBiasActGradFunction,
    fused_bias_act_grad_plain,
    fused_leaky_relu,
)

SQRT2 = math.sqrt(2.0)


def _pallas(x, b):
    return fused_leaky_relu_pallas(x, b, 0.2, SQRT2, True)


def _x_b(shape, seed, bias=True):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    c = shape[1] if len(shape) >= 3 else shape[-1]
    return x, (rng.randn(c).astype(np.float32) if bias else None)


@pytest.mark.parametrize("shape", [(2, 8, 4, 4), (2, 16, 16, 16), (3, 130)])
def test_fused_act_function_forward_matches_pallas(shape):
    """Forward through the autograd Function: rtol = atol = 1e-6."""
    x, b = _x_b(shape, 0)
    got = fused_leaky_relu(torch.from_numpy(x).requires_grad_(), torch.from_numpy(b).requires_grad_())
    want = np.asarray(_pallas(jnp.asarray(x), jnp.asarray(b)))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,bias", [((2, 8, 8, 8), True), ((3, 130), True), ((4, 32), True), ((2, 8, 8, 8), False)])
def test_fused_act_first_order_matches_pallas(shape, bias):
    """(dx, db) of sum(y^2), against the Pallas kernel's custom VJP in
    interpret mode and the plain jnp form: rtol = atol = 1e-5."""
    x, b = _x_b(shape, 1, bias)
    xt = torch.from_numpy(x).requires_grad_()
    bt = None if b is None else torch.from_numpy(b).requires_grad_()
    loss = (fused_leaky_relu(xt, bt) ** 2).sum()
    got = torch.autograd.grad(loss, [xt] + ([bt] if bias else []))
    jb = None if b is None else jnp.asarray(b)
    for impl in (lambda x, b: _pallas(x, b), lambda x, b: jax_fused_leaky_relu(x, b)):
        if bias:
            want = jax.grad(lambda x, b: jnp.sum(impl(x, b) ** 2), argnums=(0, 1))(jnp.asarray(x), jb)
        else:
            want = (jax.grad(lambda x: jnp.sum(impl(x, None) ** 2))(jnp.asarray(x)),)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_fused_act_second_order_matches_pallas():
    """The R1 pattern, the grad of a grad-norm, with a bias: rtol = atol = 1e-5."""
    x, b = _x_b((2, 8, 4, 4), 2)

    def grad_norm_torch(xt, bt):
        y = fused_leaky_relu(xt, bt)
        (gx,) = torch.autograd.grad((y**2).sum(), xt, create_graph=True)
        return (gx**2).sum()

    xt, bt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(b).requires_grad_()
    got = torch.autograd.grad(grad_norm_torch(xt, bt), [xt, bt])

    def gn(impl):
        return lambda x, b: jnp.sum(jax.grad(lambda x: jnp.sum(impl(x, b) ** 2))(x) ** 2)

    for impl in (_pallas, jax_fused_leaky_relu):
        want = jax.grad(gn(impl), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(b))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_grad_function_rule():
    """FusedBiasActGradFunction: the plain gradient equals the JAX kernel's
    (`_grad_from_y`, interpret mode) exactly; its derivative with respect to
    dy is the gate, with respect to y zero."""
    from maua_tpu.ops.pallas_act import _grad_from_y

    rng = np.random.RandomState(3)
    dy, y = rng.randn(2, 8, 4, 4).astype(np.float32), rng.randn(2, 8, 4, 4).astype(np.float32)
    got = fused_bias_act_grad_plain(torch.from_numpy(dy), torch.from_numpy(y))
    want = np.asarray(_grad_from_y(jnp.asarray(dy), jnp.asarray(y), 0.2, SQRT2, True))
    np.testing.assert_array_equal(got.numpy(), want)
    dyt, yt = torch.from_numpy(dy).requires_grad_(), torch.from_numpy(y).requires_grad_()
    ddx = torch.from_numpy(rng.randn(2, 8, 4, 4).astype(np.float32))
    d_dy, d_y = torch.autograd.grad(FusedBiasActGradFunction.apply(dyt, yt, 0.2, SQRT2), [dyt, yt], ddx, allow_unused=True)
    np.testing.assert_array_equal(d_dy.numpy(), fused_bias_act_grad_plain(ddx, torch.from_numpy(y)).numpy())
    assert d_y is None


def test_fused_act_bf16_bias_grad_dtype():
    """bf16 input: dx is bf16, db is summed in dx's dtype (as JAX's
    jnp.sum(dx)) and handed back in the bias's dtype, fp32."""
    x = torch.randn(2, 8, 4, 4).bfloat16().requires_grad_()
    b = torch.randn(8).requires_grad_()
    y = fused_leaky_relu(x, b)
    assert y.dtype == torch.bfloat16
    dx, db = torch.autograd.grad(y.float().sum(), [x, b])
    assert dx.dtype == torch.bfloat16 and db.dtype == torch.float32
    torch.testing.assert_close(db, dx.sum(dim=(0, 2, 3)).float(), rtol=0, atol=0)


# ---------------------------------------------------------------- D and losses
from maua_tpu.models.blocks import minibatch_stddev as jax_minibatch_stddev  # noqa: E402
from maua_tpu.train import losses as jax_losses  # noqa: E402
from maua_tpu_torch.models import Discriminator, minibatch_stddev  # noqa: E402
from maua_tpu_torch.train import losses  # noqa: E402


@pytest.mark.parametrize("b,group", [(8, 4), (6, 4), (4, 4), (2, 4)])
def test_minibatch_stddev_matches_jax(b, group):
    """rtol = atol = 1e-6; includes a batch the group does not divide."""
    x = np.random.RandomState(4).randn(b, 6, 3, 3).astype(np.float32)
    got = minibatch_stddev(torch.from_numpy(x), group).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_minibatch_stddev(jnp.asarray(x), group)), rtol=1e-6, atol=1e-6)


def test_minibatch_stddev_keeps_interleaved_halves_apart():
    """In an interleaved [f0, r0, f1, r1, ...] batch of 2B = 8, every stddev
    group is all fake or all real: the statistic of the fakes does not move
    when the reals change."""
    x = np.random.RandomState(5).randn(8, 4, 2, 2).astype(np.float32)
    y = x.copy()
    y[1::2] *= 3.0
    a = minibatch_stddev(torch.from_numpy(x), 4)[0::2, -1]
    b = minibatch_stddev(torch.from_numpy(y), 4)[0::2, -1]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_discriminator_matches_jax_with_hidden():
    """D logits and the hidden activation against the JAX Discriminator on
    the same weights: max abs 1e-5 (the frameworks sum the convs in different
    orders). The weights go to JAX through the JAX package's rosinality
    converter and come back through `discriminator_state_dict_from_jax`,
    which must return the state dict it was given."""
    from maua_tpu_torch.io import discriminator_state_dict_from_jax

    _, st = port_state()
    sd = st.d.state_dict()
    params = discriminator_variables_from_torch({k: v.numpy().copy() for k, v in sd.items()})["params"]
    back = discriminator_state_dict_from_jax(params)
    assert sorted(back) == sorted(sd)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)
    td = Discriminator(size=16, channel_max=32)
    td.load_state_dict(back, strict=True)
    x = np.random.RandomState(6).randn(8, 3, 16, 16).astype(np.float32)
    want, want_h = JaxDiscriminator(size=16, channel_max=32).apply({"params": params}, jnp.asarray(x), return_hidden=True)
    with torch.no_grad():
        got, got_h = td(torch.from_numpy(x), return_hidden=True)
    assert got.shape == (8, 1) and got_h.shape == tuple(want_h.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-5, atol=1e-5)


def test_losses_match_jax():
    """Logistic, non-saturating, R1 (grad of sum D wrt the image) and the
    path-length penalty: rtol 1e-5 (R1 and path 1e-4: second-order sums)."""
    rng = np.random.RandomState(7)
    real, fake = rng.randn(6, 1).astype(np.float32), rng.randn(6, 1).astype(np.float32)
    np.testing.assert_allclose(
        float(losses.d_logistic_loss(torch.from_numpy(real), torch.from_numpy(fake))),
        float(jax_losses.d_logistic_loss(jnp.asarray(real), jnp.asarray(fake))), rtol=1e-6)
    np.testing.assert_allclose(
        float(losses.g_nonsaturating_loss(torch.from_numpy(fake))),
        float(jax_losses.g_nonsaturating_loss(jnp.asarray(fake))), rtol=1e-6)
    # R1 on a smooth function of the image with the fused act inside
    w = rng.randn(3).astype(np.float32)
    img = rng.randn(4, 3, 5, 5).astype(np.float32)
    d_t = lambda x: fused_leaky_relu(x * torch.from_numpy(w)[None, :, None, None]).sum(dim=(1, 2, 3))
    d_j = lambda x: jax_fused_leaky_relu(x * jnp.asarray(w)[None, :, None, None]).sum(axis=(1, 2, 3))
    np.testing.assert_allclose(float(losses.d_r1_penalty(d_t, torch.from_numpy(img)).detach()),
                               float(jax_losses.d_r1_penalty(d_j, jnp.asarray(img))), rtol=1e-5)
    # path length with a fixed noise image: the JAX function draws it from rng
    lat = rng.randn(2, 4, 8).astype(np.float32)
    m = rng.randn(8, 3 * 4 * 4).astype(np.float32) / 4
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, (2, 3, 4, 4)))
    g_j = lambda l: (jax_fused_leaky_relu(l.mean(1) @ jnp.asarray(m)).reshape(-1, 3, 4, 4), l)
    g_t = lambda l: fused_leaky_relu(l.mean(1) @ torch.from_numpy(m)).reshape(-1, 3, 4, 4)
    pen_j, mean_j, pl_j = jax_losses.g_path_length_regularization(g_j, jnp.asarray(lat), jnp.asarray(0.5), key)
    lat_t = torch.from_numpy(lat).requires_grad_()
    pen_t, mean_t, pl_t = losses.g_path_length_regularization(g_t, lat_t, torch.tensor(0.5), torch.from_numpy(noise))
    np.testing.assert_allclose(pl_t.detach().numpy(), np.asarray(pl_j), rtol=1e-5)
    np.testing.assert_allclose(float(mean_t), float(mean_j), rtol=1e-5)
    np.testing.assert_allclose(float(pen_t.detach()), float(pen_j), rtol=1e-4)


# ---------------------------------------------------------------- optimizer, EMA, lookahead
from maua_tpu.train import ema_update as jax_ema_update  # noqa: E402
from maua_tpu.train import lookahead_minimax_init as jax_la_init  # noqa: E402
from maua_tpu.train import lookahead_minimax_step as jax_la_step  # noqa: E402
from maua_tpu_torch.train import ema_update, lookahead_minimax_init, lookahead_minimax_step, reg_adjusted_adam  # noqa: E402


@pytest.mark.parametrize("reg_every", [4, 16])
def test_adam_matches_optax_on_the_same_gradients(reg_every):
    """Three steps of the lazy-reg-adjusted Adam fed the same gradients
    (including a zero one, as R1 gives D's last bias): rtol 1e-6."""
    import optax

    rng = np.random.RandomState(8)
    p0 = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32) * s for s in (1.0, 1e-3, 0.0)]
    opt = _reg_adjusted_adam(2e-3, reg_every)
    pj, sj = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = reg_adjusted_adam([pt], 2e-3, reg_every)
    for g in grads:
        upd, sj = opt.update(jnp.asarray(g), sj, pj)
        pj = optax.apply_updates(pj, upd)
        pt.grad = torch.from_numpy(g.copy())
        topt.step()
        np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), rtol=1e-6, atol=1e-7)


def test_ema_and_lookahead_match_jax():
    """EMA (one update) and lookahead-minimax (k = 2, two steps): rtol 1e-6."""
    rng = np.random.RandomState(9)
    e, p = rng.randn(4, 3).astype(np.float32), rng.randn(4, 3).astype(np.float32)
    et = [torch.from_numpy(e.copy())]
    ema_update(et, [torch.from_numpy(p)], 0.9)
    np.testing.assert_allclose(et[0].numpy(), np.asarray(jax_ema_update({"w": jnp.asarray(e)}, {"w": jnp.asarray(p)}, 0.9)["w"]), rtol=1e-6)

    g0, d0, g1, d1 = (rng.randn(3).astype(np.float32) for _ in range(4))
    js = jax_la_init({"w": jnp.asarray(g0)}, {"w": jnp.asarray(d0)})
    gt, dt = [torch.from_numpy(g0.copy())], [torch.from_numpy(d0.copy())]
    ts = lookahead_minimax_init(gt, dt)
    for step in range(2):
        gt[0].copy_(torch.from_numpy(g1 + step)), dt[0].copy_(torch.from_numpy(d1 - step))
        js, jg, jd = jax_la_step(js, {"w": jnp.asarray(g1 + step)}, {"w": jnp.asarray(d1 - step)}, k=2, alpha=0.5)
        synced = lookahead_minimax_step(ts, gt, dt, k=2, alpha=0.5)
        assert synced == (step == 1)
        np.testing.assert_allclose(gt[0].numpy(), np.asarray(jg["w"]), rtol=1e-6)
        np.testing.assert_allclose(dt[0].numpy(), np.asarray(jd["w"]), rtol=1e-6)
    np.testing.assert_allclose(ts.slow_g[0].numpy(), np.asarray(js.slow_g["w"]), rtol=1e-6)


# ---------------------------------------------------------------- D and R1 phases
from maua_tpu.train.step import make_train_phases as jax_make_train_phases  # noqa: E402
from maua_tpu_torch.train import make_train_phases  # noqa: E402

GRAD_RTOL = 1e-4


def _reals(a, b, seed=11):
    return np.random.RandomState(seed).uniform(-1, 1, (a, b, 3, 16, 16)).astype(np.float32)


@pytest.mark.parametrize("num_accumulate", [1, 2])
def test_d_phase_matches_jax(num_accumulate):
    """The interleaved fake/real D pass (batch 4 = the stddev group): D loss,
    scores and D gradients against the JAX D phase, on the JAX phase's own
    draws. Loss rtol 1e-5; gradients max abs <= 1e-4 x the tensor's max."""
    cfg, st = port_state(num_accumulate=num_accumulate)
    js = JaxSide(st, num_accumulate=num_accumulate)
    real = _reals(num_accumulate, 4)
    rng = jax.random.PRNGKey(21)
    new, aux_j = jax_make_train_phases(js.gen, js.disc, js.cfg)["d"](js.state, jnp.asarray(real), rng)
    aux_t, grads_t = make_train_phases(cfg)["d"](st, torch.from_numpy(real), js.d_draws(rng))
    for k in ("d_loss", "real_score", "fake_score"):
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]), rtol=1e-5, atol=1e-6)
    assert_grads_close(port_grads(st.d, grads_t), js.grads_d(new), GRAD_RTOL)


@pytest.mark.parametrize("batch,reg_chunks", [(4, 1), (8, 2)])
def test_r1_phase_matches_jax(batch, reg_chunks):
    """R1 on raw reals, a double backward through D: the penalty (rtol 1e-5)
    and D's gradients (max abs <= 1e-4 x the tensor's max) against the JAX R1
    phase, unchunked. The port's R1 in two strided chunks of one stddev group
    each is the unchunked R1; the JAX package's contiguous chunks regroup the
    minibatch-stddev statistic, so the JAX side runs unchunked."""
    cfg, st = port_state(batch_size=batch, reg_chunks=reg_chunks)
    js = JaxSide(st, batch_size=batch)
    real = _reals(1, batch)
    new, r1_j = jax_make_train_phases(js.gen, js.disc, js.cfg)["r1"](js.state, jnp.asarray(real), jax.random.PRNGKey(0))
    r1_t, grads_t = make_train_phases(cfg)["r1"](st, torch.from_numpy(real))
    np.testing.assert_allclose(float(r1_t), float(r1_j), rtol=1e-5)
    assert_grads_close(port_grads(st.d, grads_t), js.grads_d(new), GRAD_RTOL)


# ---------------------------------------------------------------- D phase with ADA, bCR, contrastive
ADA = dict(augment=True, augment_p=0.5)


@pytest.mark.parametrize("batch,over", [
    (4, {}),  # the fused [2B] pass, augmented with one draw
    pytest.param(2, {}, marks=pytest.mark.slow),  # a batch the stddev group does not divide: apart
    (4, dict(bcr_weight=1.0)),  # bCR: fakes and reals apart
    pytest.param(4, dict(ada_warp_method="fft"), marks=pytest.mark.slow),
])
def test_d_phase_with_ada_matches_jax(batch, over):
    """ADA at p = 0.5 on the JAX phase's own augmentation draws (CPU warp:
    conv, or fft): D loss and scores (rtol 1e-5), ADA's sign sum and count
    (exact), D gradients (max abs <= 1e-4 x the tensor's max)."""
    kw = {**ADA, **over, "batch_size": batch}
    cfg, st = port_state(**kw)
    js = JaxSide(st, **kw)
    real = _reals(1, batch)
    rng = jax.random.PRNGKey(22)
    new, aux_j = jax_make_train_phases(js.gen, js.disc, js.cfg)["d"](js.state, jnp.asarray(real), rng)
    draws = js.d_draws(rng)
    assert len(draws[0].aug) == (1 if batch == 4 and "bcr_weight" not in over else 2)
    aux_t, grads_t = make_train_phases(cfg)["d"](st, torch.from_numpy(real), draws)
    for k in ("d_loss", "real_score", "fake_score"):
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]), rtol=1e-5, atol=1e-6)
    for k in ("sign_sum", "n_pred"):
        assert float(aux_t[k]) == float(aux_j[k]), k
    assert_grads_close(port_grads(st.d, grads_t), js.grads_d(new), GRAD_RTOL)


@pytest.mark.parametrize("momentum,queue", [pytest.param(0.0, 0, marks=pytest.mark.slow), (0.9, 16)])
def test_d_phase_with_contrastive_matches_jax(momentum, queue):
    """The contrastive regularizer (weight 0.5, bilinear key transform) in
    the unfused ADA D phase; with MoCo a key encoder that differs from D and
    a half-filled queue of 16. Loss (rtol 1e-5), D's and the head's
    gradients (max abs <= 1e-4 x max), the new queue (1e-5), cursor and
    fill, and the key encoder moved towards the updated D by the momentum
    rule (rtol 1e-6; the rule itself is held against the JAX package in
    test_torch_port_contrastive.py)."""
    kw = dict(ADA, contrastive_weight=0.5, contrastive_bilinear=True, contrastive_momentum=momentum,
              contrastive_queue=queue)
    cfg, st = port_state(**kw)
    rng_np = np.random.RandomState(30)
    with torch.no_grad():
        st.cl_head.bw.add_(torch.from_numpy(0.1 * rng_np.randn(128, 128).astype(np.float32)))
        if st.cl_state is not None:
            for p in st.cl_state.key_d.parameters():
                p.add_(torch.from_numpy(0.05 * rng_np.randn(*p.shape).astype(np.float32)))
            q = torch.from_numpy(rng_np.randn(queue, 128).astype(np.float32))
            q[8:] = 0
            st.cl_state = st.cl_state._replace(queue=q / q.norm(dim=1, keepdim=True).clamp(min=1e-8),
                                               queue_ptr=torch.tensor(8), queue_filled=torch.tensor(8))
    js = JaxSide(st, **kw)
    js.add_contrastive(st)
    key0 = [] if st.cl_state is None else [p.clone() for p in st.cl_state.key_d.parameters()]
    real = _reals(1, 4)
    rng = jax.random.PRNGKey(23)
    new, aux_j = jax_make_train_phases(js.gen, js.disc, js.cfg)["d"](js.state, jnp.asarray(real), rng)
    aux_t, grads_t = make_train_phases(cfg)["d"](st, torch.from_numpy(real), js.d_draws(rng))
    np.testing.assert_allclose(float(aux_t["d_loss"]), float(aux_j["d_loss"]), rtol=1e-5, atol=1e-6)
    assert_grads_close(port_grads(st.d, grads_t), js.grads_d(new), GRAD_RTOL)
    n_d = len(list(st.d.parameters()))
    head_mu = new.d_opt_state[0].mu[1]
    assert_grads_close({n: g.numpy() for (n, _), g in zip(st.cl_head.named_parameters(), grads_t[n_d:])},
                       {k: np.asarray(v) for k, v in head_mu.items()}, GRAD_RTOL)
    if queue:
        np.testing.assert_allclose(st.cl_state.queue.numpy(), np.asarray(new.cl_state.queue), rtol=0, atol=1e-5)
        assert int(st.cl_state.queue_ptr) == int(new.cl_state.queue_ptr) == 0
        assert int(st.cl_state.queue_filled) == int(new.cl_state.queue_filled) == 16
        for k, k0, p in zip(st.cl_state.key_d.parameters(), key0, st.d.parameters()):
            torch.testing.assert_close(k, k0 * 0.9 + 0.1 * p, rtol=1e-6, atol=1e-7)


def test_cli_wandb_unavailable_trains_on(tmp_path, capsys):
    """--wandb where wandb is not installed: the JAX CLI's fallback, a
    `wandb unavailable (...)` line, and training goes on into metrics.jsonl."""
    import importlib.util
    import json
    import os

    from maua_tpu_torch.data.synthetic import write_synth_shards
    from maua_tpu_torch.train.cli import main

    assert importlib.util.find_spec("wandb") is None
    write_synth_shards(str(tmp_path / "s"), 16, 8, fmt="raw", seed=1)
    run = str(tmp_path / "run")
    assert main(["--path", str(tmp_path / "s"), "--size", "16", "--batch_size", "4", "--channel_max", "8",
                 "--device", "cpu", "--run_dir", run, "--iter", "2", "--log_every", "1", "--img_every", "0",
                 "--num_workers", "1", "--no-augment", "--wandb"]) == 0
    assert "wandb unavailable (" in capsys.readouterr().out
    assert [json.loads(x)["step"] for x in open(os.path.join(run, "metrics.jsonl"))] == [0, 1]

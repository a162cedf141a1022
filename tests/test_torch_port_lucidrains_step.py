"""One lucidrains train step of maua_tpu_torch against maua_tpu's on the CPU,
in fp32: the same S, G, D weights (carried across by
`io.lucidrains_state_dict_from_jax`), the same reals and JAX's own draws
(rebuilt from the step's key as the JAX step splits it), gradient
accumulation over two microbatches, fq and attention on.

Step 0 runs the gradient penalty and the path penalty; with ema_start 0 and
ema_every 1, step 1 runs the EMA and step 2 the reset of the EMA copies
(which start away from S and G, so both branches show). Checked: the
metrics (rtol 1e-4), D's and S + G's gradients as the DiffGrads keep them
(the previous gradient, within 1e-4 of each tensor's largest), the weights
after DiffGrad, the EMA copies and pl_mean. The weights are held where the
gradient is above 1e-3 of its tensor's largest (to 1e-6 of the largest
weight): DiffGrad's first step is lr * sigmoid(|g|) * sign(g), so an element
whose gradient is within rounding of zero may step the other way in either
library.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.models import lucidrains as J
from maua_tpu.train import lucidrains_trainer as JT
from maua_tpu_torch.io import lucidrains_state_dict_from_jax
from maua_tpu_torch.models.lucidrains import StyleDraw
from maua_tpu_torch.train import LucidrainsConfig, init_lucidrains_state, make_lucidrains_train_step
from maua_tpu_torch.train.lucidrains_trainer import LucidrainsDraw, LucidrainsStepDraws
from test_torch_port_lucidrains import flax_params

CFG = dict(image_size=16, latent_dim=16, style_depth=2, network_capacity=2, batch_size=2, gradient_accumulate_every=2,
           fq_layers=(1,), fq_dict_size=8, attn_layers=(2,), ema_start=0, ema_every=1)
N_LAYERS = 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs: the models are tiny, and
    with several test workers on the host, eight threads per worker made a
    3 s test take minutes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def jax_draws(rng, cfg) -> LucidrainsStepDraws:
    """The draws of JAX's train_step(state, real, rng), in the port's form."""
    b, s, acc = cfg.batch_size, cfg.image_size, cfg.gradient_accumulate_every

    def style(kw):
        k1, k2, k3, k4 = jax.random.split(kw, 4)
        return StyleDraw(t(jax.random.normal(k1, (b, cfg.latent_dim))), t(jax.random.normal(k2, (b, cfg.latent_dim))),
                         t(jax.random.bernoulli(k3, cfg.mixed_prob, (b,))), t(jax.random.randint(k4, (b,), 1, N_LAYERS)))

    k_d, k_g = jax.random.split(rng)
    d = []
    for key in jax.random.split(k_d, acc):
        kw, kn = jax.random.split(key)
        d.append(LucidrainsDraw(style(kw), t(jax.random.uniform(kn, (b, s, s, 1)))))
    g = []
    for key in jax.random.split(k_g, acc):
        kw, kn, kp = jax.random.split(key, 3)
        g.append(LucidrainsDraw(style(kw), t(jax.random.uniform(kn, (b, s, s, 1))),
                                t(jax.random.normal(kp, (b, N_LAYERS, cfg.latent_dim)))))
    return LucidrainsStepDraws(d=d, g=g)


def sd_np(m: torch.nn.Module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in m.state_dict().items()}


def rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(np.asarray(b)).max(), 1e-12))


@pytest.fixture(scope="module")
def jax_step():
    return jax.jit(JT.make_lucidrains_train_step(JT.LucidrainsConfig(**CFG)))


@pytest.mark.parametrize("step", [0, 1, 2])
def test_train_step_matches_jax(jax_step, step):
    cfg = LucidrainsConfig(**CFG)
    st = init_lucidrains_state(cfg, seed=3, device="cpu")
    n = N_LAYERS
    z = np.zeros((2, 16), np.float32)
    shapes = {"s": (J.StyleVectorizer(16, 2), z),
              "g": (J.LucidrainsGenerator(16, 16, 2, attn_layers=(2,)), np.zeros((2, n, 16), np.float32),
                    np.zeros((2, 16, 16, 1), np.float32)),
              "d": (J.LucidrainsDiscriminator(16, 2, fq_layers=(1,), fq_dict_size=8, attn_layers=(2,)),
                    np.zeros((2, 3, 16, 16), np.float32))}
    params = {k: flax_params(getattr(st, k), *v) for k, v in shapes.items()}
    for k, p in params.items():  # the rezero gains at 0.5 on both sides
        getattr(st, k).load_state_dict(lucidrains_state_dict_from_jax(p), strict=True)
    rng = np.random.default_rng(step)
    ema = {}
    for k in ("s", "g"):  # EMA copies away from S and G
        ema[k] = jax.tree_util.tree_map(lambda a: (a + 0.05 * rng.standard_normal(np.shape(a))).astype(np.float32), params[k])
        getattr(st, k + "e").load_state_dict(lucidrains_state_dict_from_jax(ema[k]), strict=True)
    st.step, st.pl_mean = step, torch.tensor(0.05)
    jcfg = JT.LucidrainsConfig(**CFG)
    g_opt, d_opt = JT.diffgrad(jcfg.lr), JT.diffgrad(jcfg.lr)
    jstate = JT.LucidrainsTrainState(
        step=jnp.asarray(step, jnp.int32), s_params=params["s"], g_params=params["g"], d_params=params["d"],
        se_params=ema["s"], ge_params=ema["g"], g_opt_state=g_opt.init((params["s"], params["g"])),
        d_opt_state=d_opt.init(params["d"]), pl_mean=jnp.asarray(0.05, jnp.float32))
    real = rng.uniform(-1, 1, (2, 2, 3, 16, 16)).astype(np.float32)
    key = jax.random.PRNGKey(17 + step)
    new, want = jax_step(jstate, jnp.asarray(real), key)
    got = make_lucidrains_train_step(cfg)(st, torch.from_numpy(real), jax_draws(key, cfg))

    assert st.step == step + 1 and (float(got["R1"]) > 0) == (step == 0) and (float(got["Path Length"]) > 0) == (step == 0)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-7, err_msg=k)

    conv = lambda tree: lucidrains_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree))  # noqa: E731
    j_grads = {"d": conv(new.d_opt_state.prev_grad), "s": conv(new.g_opt_state.prev_grad[0]),
               "g": conv(new.g_opt_state.prev_grad[1])}
    j_weights = {"d": conv(new.d_params), "s": conv(new.s_params), "g": conv(new.g_params),
                 "se": conv(new.se_params), "ge": conv(new.ge_params)}
    opts = {"d": st.d_opt, "s": st.g_opt, "g": st.g_opt}
    for net in ("d", "s", "g"):
        module = getattr(st, net)
        for name, p in module.named_parameters():
            g_port = opts[net].state[p]["prev_grad"].numpy()
            g_jax = j_grads[net][name].numpy()
            assert rel(g_port, g_jax) <= 1e-4, (net, name, rel(g_port, g_jax))
            mask = np.abs(g_jax) > 1e-3 * np.abs(g_jax).max()
            w_port, w_jax = p.detach().numpy(), j_weights[net][name].numpy()
            assert np.abs(w_port - w_jax)[mask].max(initial=0) <= 1e-6 * max(np.abs(w_jax).max(), 1.0), (net, name)
    for net in ("se", "ge"):
        got_sd, cur, before = sd_np(getattr(st, net)), sd_np(getattr(st, net[0])), conv(ema[net[0]])
        for name, want_w in j_weights[net].items():
            # against JAX: DiffGrad's near-zero steps, copied by the reset, differ by lr at most
            assert np.abs(got_sd[name] - want_w.numpy()).max() <= 1e-6 + cfg.lr, (net, name)
            if step == 0:  # neither branch: the copies are untouched
                np.testing.assert_array_equal(got_sd[name], before[name].numpy())
            elif step == 1:  # the EMA of the updated weights
                np.testing.assert_allclose(got_sd[name], 0.995 * before[name].numpy() + 0.005 * cur[name], rtol=1e-6, atol=1e-7)
            else:  # the reset
                np.testing.assert_array_equal(got_sd[name], cur[name])
    np.testing.assert_allclose(float(st.pl_mean), float(new.pl_mean), rtol=1e-4)

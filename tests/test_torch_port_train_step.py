"""maua_tpu_torch's G and path-length phases against maua_tpu's, and the
port's train step options, on the CPU in fp32 (set-up shared with
test_torch_port_train.py: one narrow model in both packages, the JAX phases'
own draws carried across, JAX gradients read from Adam's first moment).

Against the JAX package: the G phase (loss and G gradients, the mapping
network's included) and the path-length phase (penalty, the new running mean
and G gradients, the mapping network's included, unchunked and in two
chunks). Within the port: R1 in chunks against R1 unchunked, the G phase with
`remat_synth` against the G phase without it, a uint8 batch against the same
batch in fp32, the guards, and a whole step with lookahead and EMA.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.train.step import make_train_phases as jax_make_train_phases
from maua_tpu_torch.train import draw_step, make_train_phases, make_train_step
from test_torch_port_train import GRAD_RTOL, JaxSide, assert_grads_close, port_grads, port_state


@pytest.mark.parametrize("constant_input", [True, False])
def test_g_phase_matches_jax(constant_input):
    """Non-saturating G loss (rtol 1e-5) and G gradients, mapping layers
    included (max abs <= 1e-4 x the tensor's max), with constant and with
    latent-mapped input."""
    cfg, st = port_state(constant_input=constant_input)
    js = JaxSide(st, constant_input=constant_input)
    rng = jax.random.PRNGKey(31)
    new, loss_j = jax_make_train_phases(js.gen, js.disc, js.cfg)["g"](js.state, rng)
    loss_t, grads_t = make_train_phases(cfg)["g"](st, js.g_draws(rng))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    got = port_grads(st.g, grads_t)
    assert np.abs(got["style.1.weight"]).max() > 0  # the loss reaches the mapping network
    assert_grads_close(got, js.grads_g(new), GRAD_RTOL)


@pytest.mark.parametrize("batch,reg_chunks", [(4, 1), (8, 2)])
def test_path_phase_matches_jax(batch, reg_chunks):
    """Path-length penalty (a double backward through G to W+): the penalty
    and the new running mean (rtol 1e-4) and G's gradients (max abs <= 1e-4 x
    the tensor's max), the mapping network's included: the penalty reaches it
    through W+. Unchunked, and in two chunks with their own draws."""
    cfg, st = port_state(batch_size=batch, reg_chunks=reg_chunks)
    st.mean_path_length = torch.tensor(0.05)
    js = JaxSide(st, batch_size=batch, reg_chunks=reg_chunks)
    js.state = js.state.replace(mean_path_length=jnp.asarray(0.05))
    rng = jax.random.PRNGKey(41)
    new, pen_j = jax_make_train_phases(js.gen, js.disc, js.cfg)["path"](js.state, rng)
    pen_t, grads_t = make_train_phases(cfg)["path"](st, js.path_draws(rng))
    np.testing.assert_allclose(float(pen_t), float(pen_j), rtol=1e-4)
    np.testing.assert_allclose(float(st.mean_path_length), float(new.mean_path_length), rtol=1e-4)
    got = port_grads(st.g, grads_t)
    assert np.abs(got["style.1.weight"]).max() > 0
    assert_grads_close(got, js.grads_g(new), GRAD_RTOL)


def _draws(cfg, step=0, seed=5):
    return draw_step(cfg, step, torch.Generator().manual_seed(seed), "cpu")


def _reals(a, b, seed=12):
    return torch.from_numpy(np.random.RandomState(seed).uniform(-1, 1, (a, b, 3, 16, 16)).astype(np.float32))


def test_r1_chunks_equal_unchunked():
    """R1 in two chunks of one stddev group is the unchunked R1: penalty and
    gradients to rtol 1e-5 (only the order of the sums differs)."""
    cfg1, st1 = port_state(batch_size=8)
    cfg2, st2 = port_state(batch_size=8, reg_chunks=2)
    real = _reals(1, 8)
    r1_a, g_a = make_train_phases(cfg1)["r1"](st1, real)
    r1_b, g_b = make_train_phases(cfg2)["r1"](st2, real)
    np.testing.assert_allclose(float(r1_b), float(r1_a), rtol=1e-5)
    for a, b in zip(g_a, g_b):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7)


def test_reg_chunks_guards():
    with pytest.raises(ValueError, match="must divide"):
        make_train_phases(port_state(batch_size=4, reg_chunks=3)[0])
    cfg, st = port_state(batch_size=4, reg_chunks=2)
    with pytest.raises(ValueError, match="stddev group"):
        make_train_phases(cfg)["r1"](st, _reals(1, 4))


def test_remat_synth_equals_plain_g_phase():
    """Activation checkpointing of the synthesis with the draws passed in:
    the same loss and gradients as without it (rtol 1e-6)."""
    cfg1, st1 = port_state()
    cfg2, st2 = port_state(remat_synth=True)
    draws = _draws(cfg1).g
    l_a, g_a = make_train_phases(cfg1)["g"](st1, draws)
    l_b, g_b = make_train_phases(cfg2)["g"](st2, draws)
    np.testing.assert_allclose(float(l_b), float(l_a), rtol=1e-6)
    for a, b in zip(g_a, g_b):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-8)


def test_uint8_batch_equals_fp32_batch():
    """A [A, B, H, W, 3] uint8 batch normalised in the step gives the metrics
    and weights of the same batch converted to fp32 on the host
    (x / 127.5 - 1): rtol 1e-6."""
    u8 = np.random.RandomState(13).randint(0, 256, (1, 4, 16, 16, 3)).astype(np.uint8)
    f32 = u8.transpose(0, 1, 4, 2, 3).astype(np.float32) * np.float32(1 / 127.5) - np.float32(1)
    out = []
    for batch in (torch.from_numpy(u8), torch.from_numpy(f32)):
        cfg, st = port_state()
        metrics = make_train_step(cfg)(st, batch, _draws(cfg))
        out.append((metrics, [p.detach().clone() for p in st.d.parameters()]))
    for k in out[0][0]:
        np.testing.assert_allclose(float(out[0][0][k]), float(out[1][0][k]), rtol=1e-6, err_msg=k)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)
    with pytest.raises(ValueError, match="uint8"):
        make_train_step(cfg)(st, torch.from_numpy(u8[..., :2]), _draws(cfg))


def test_train_step_runs_every_phase_with_lookahead_and_ema():
    """Four steps with R1 and the path penalty due at steps 0 and 2
    (d_reg_every 2, g_reg_every 2, la_steps 2): finite metrics with the JAX
    names, the step counter, the lookahead sync after the second step (G
    equal to its slow copy) and the EMA moving towards G. A step whose path
    penalty is due refuses draws without path draws."""
    cfg, st = port_state(lookahead=True, la_steps=2, d_reg_every=2, g_reg_every=2)
    ema0 = [p.clone() for p in st.g_ema.parameters()]
    step = make_train_step(cfg)
    gen = torch.Generator().manual_seed(0)
    for i in range(4):
        m = step(st, _reals(1, 4, seed=i), draw_step(cfg, st.step, gen, "cpu"))
        assert all(np.isfinite(float(v)) for v in m.values())
        assert (float(m["R1 Penalty"]) > 0) == (i % 2 == 0)
        assert (float(m["Path Length Regularization"]) > 0) == (i % 2 == 0)
        if i == 1:  # lookahead synced after the second G step
            for p, s in zip(st.g.parameters(), st.lookahead.slow_g):
                torch.testing.assert_close(p, s, rtol=0, atol=0)
    assert st.step == 4 and st.lookahead.step == 4
    assert set(m) == {"Generator", "Discriminator", "Real Score", "Fake Score", "R1 Penalty",
                      "Path Length Regularization", "Rt", "Augment", "Mean Path Length"}
    moved = [float((e - e0).abs().max()) for e, e0 in zip(st.g_ema.parameters(), ema0)]
    assert max(moved) > 0
    with pytest.raises(ValueError, match="path"):
        step(st, _reals(1, 4), draw_step(cfg, 1, gen, "cpu"))


def test_unported_options_raise():
    from maua_tpu_torch.train import init_train_state, make_train_config

    for kw in (dict(augment=True), dict(augment=False, bcr_weight=1.0), dict(augment=False, contrastive_weight=0.1)):
        cfg = make_train_config(size=16, batch_size=4, channel_max=32, **kw)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            init_train_state(cfg, device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_train_phases(cfg)

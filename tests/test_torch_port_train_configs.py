"""Whole train steps of maua_tpu_torch on the CPU in fp32 (the set-up of
test_torch_port_train.py): four steps with lookahead and EMA, and one step of
each ADA, bCR and contrastive configuration. A file of its own beside
test_torch_port_train_step.py, so that the two run on two workers."""

import numpy as np
import pytest
import torch

from maua_tpu_torch.train import draw_step, make_train_step
from test_torch_port_train import port_state
from test_torch_port_train_step import _draws, _reals


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
                      "Path Length Regularization", "Rt", "Augment", "Mean Path Length", "sign_sum", "n_pred"}
    moved = [float((e - e0).abs().max()) for e, e0 in zip(st.g_ema.parameters(), ema0)]
    assert max(moved) > 0
    with pytest.raises(ValueError, match="path"):
        step(st, _reals(1, 4), draw_step(cfg, 1, gen, "cpu"))


@pytest.mark.parametrize("over", [
    dict(augment=True),
    pytest.param(dict(augment=True, augment_p=0.3, ada_warp_method="fft", bf16=True), marks=pytest.mark.slow),
    pytest.param(dict(augment=True, augment_p=0.3, ada_fast_warp=True), marks=pytest.mark.slow),
    dict(bcr_weight=1.0),
    dict(contrastive_weight=0.1, contrastive_momentum=0.99, contrastive_queue=8),
    pytest.param(dict(contrastive_weight=0.1, contrastive_loss_type="nt_xent", contrastive_bilinear=True),
                 marks=pytest.mark.slow),
])
def test_ada_bcr_contrastive_configs_step_on_the_cpu(over):
    """Each configuration builds and takes a step with R1 and the path
    penalty on the CPU: finite metrics with the JAX names plus ADA's counts,
    and the head (when there is one) moved by D's optimizer, which R1 steps
    too. bCR and the contrastive regularizer turn augmentation on."""
    cfg, st = port_state(d_reg_every=1, g_reg_every=1, **over)
    assert cfg.augment
    head0 = None if st.cl_head is None else st.cl_head.w1.detach().clone()
    m = make_train_step(cfg)(st, _reals(1, 4), _draws(cfg))
    assert all(np.isfinite(float(v)) for v in m.values())
    assert float(m["R1 Penalty"]) > 0 and float(m["n_pred"]) == 4.0
    assert float(m["Augment"]) == np.float32(cfg.augment_p)
    if head0 is not None:
        assert float((st.cl_head.w1.detach() - head0).abs().max()) > 0
        assert st.d_optim.state[st.cl_head.w1]["step"] == 2  # the D phase and R1
    if cfg.contrastive_queue:
        assert int(st.cl_state.queue_filled) == 8 and int(st.cl_state.queue_ptr) == 0

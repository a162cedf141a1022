"""maua_tpu_torch's contrastive regularizer (train/contrastive.py) against
maua_tpu's, on the CPU: the three losses and `project` to 1e-6 (the head on
JAX's parameters through `projection_head_state_dict_from_jax`), the queue's
mechanics as `tests/test_train.py::test_contrastive_queue_mechanics` pins
them for the JAX package, the momentum update, and the whole MoCo
regularizer (loss, head gradients, new queue) with linear stand-ins for D's
hidden layer.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.train import contrastive as jcl
from maua_tpu_torch.io import projection_head_state_dict_from_jax
from maua_tpu_torch.train import contrastive as tcl


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _unit_rows(n, d, seed):
    x = np.random.RandomState(seed).randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("temperature", [0.1, 0.5])
def test_losses_match_jax(temperature):
    """InfoNCE, NT-Xent and InfoNCE with a half-filled queue, on unit rows."""
    q, k, queue = _unit_rows(6, 16, 0), _unit_rows(6, 16, 1), _unit_rows(12, 16, 2)
    _close(tcl.contrastive_loss(_t(q), _t(k), temperature), jcl.contrastive_loss(q, k, temperature), 1e-6)
    _close(tcl.nt_xent_loss(_t(q), _t(k), temperature), jcl.nt_xent_loss(q, k, temperature), 1e-6)
    for filled in (0, 5, 12):
        want = jcl.contrastive_loss_with_queue(q, k, queue, jnp.asarray(filled), temperature)
        got = tcl.contrastive_loss_with_queue(_t(q), _t(k), _t(queue), torch.tensor(filled), temperature)
        _close(got, want, 1e-6)


@pytest.mark.parametrize("bilinear", [False, True])
def test_projection_head_on_jax_parameters(bilinear):
    """The port's head loaded with JAX's initial head gives JAX's `project`
    output (1e-6), from [B, C, 4, 4] features; the 1e-8 norm floor keeps a
    zero row at zero."""
    feats = np.random.RandomState(3).randn(5, 8, 4, 4).astype(np.float32)
    head_j = jcl.init_projection_head(jax.random.PRNGKey(0), 128, bilinear=bilinear)
    head_t = tcl.ProjectionHead(128, bilinear=bilinear)
    head_t.load_state_dict(projection_head_state_dict_from_jax(head_j), strict=True)
    _close(tcl.project(head_t, _t(feats)), jcl.project(head_j, feats), 1e-6)
    zero = {**head_j, "b2": jnp.zeros(128), "w2": jnp.zeros((256, 128))}
    head_t.load_state_dict(projection_head_state_dict_from_jax(zero), strict=True)
    assert float(tcl.project(head_t, _t(feats)).detach().abs().max()) == 0.0


def test_queue_mechanics():
    """Unfilled slots are masked (an empty queue gives plain InfoNCE), the
    ring buffer wraps, a third write overwrites the oldest slots, and queued
    negatives that resemble the positives raise the loss."""
    rng = np.random.RandomState(0)
    q, kk, k3 = (torch.from_numpy(rng.randn(4, 8).astype(np.float32)) for _ in range(3))
    st = tcl.init_contrastive_state(None, use_momentum=False, queue_size=8, out_dim=8, device="cpu")
    assert st.key_d is None and st.queue.shape == (8, 8)
    plain = tcl.contrastive_loss(q, kk)
    assert abs(float(tcl.contrastive_loss_with_queue(q, kk, st.queue, st.queue_filled)) - float(plain)) <= 1e-6
    st = tcl.enqueue_keys(st, kk)
    assert int(st.queue_ptr) == 4 and int(st.queue_filled) == 4
    st = tcl.enqueue_keys(st, k3)
    assert int(st.queue_ptr) == 0 and int(st.queue_filled) == 8
    st2 = tcl.enqueue_keys(st, q)
    torch.testing.assert_close(st2.queue[:4], q, rtol=0, atol=0)
    torch.testing.assert_close(st2.queue[4:], k3, rtol=0, atol=0)
    assert float(tcl.contrastive_loss_with_queue(q, kk, st.queue, st.queue_filled)) > float(plain)
    assert tcl.init_contrastive_state(None, use_momentum=False, queue_size=0) is None


def test_momentum_update_matches_jax():
    """key <- key * beta + (1 - beta) * D on every parameter (1e-7); the key
    encoder is a frozen copy."""
    d = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 2))
    st = tcl.init_contrastive_state(d, use_momentum=True, queue_size=0)
    assert all(not p.requires_grad for p in st.key_d.parameters())
    old = [p.detach().numpy().copy() for p in st.key_d.parameters()]
    with torch.no_grad():
        for p in d.parameters():
            p.add_(torch.from_numpy(np.random.RandomState(1).randn(*p.shape).astype(np.float32)))
    new_d = [p.detach().numpy().copy() for p in d.parameters()]
    tcl.momentum_update(st, d, 0.9)
    want = jcl.momentum_update(jcl.ContrastiveState(key_d_params=old), new_d, 0.9).key_d_params
    for got, w in zip(st.key_d.parameters(), want):
        _close(got, w, 1e-7)


@pytest.mark.parametrize("momentum,loss_type", [(0.0, "infonce"), (0.9, "infonce"), (0.9, "nt_xent")])
def test_moco_regularizer_matches_jax(momentum, loss_type):
    """contrastive_regularizer_moco with a half-filled queue of 16 and the
    bilinear key transform, D's hidden layer a linear map (a key encoder
    that differs from it with momentum): the loss (1e-6), the head's
    gradients (1e-5 x max) and the new queue, cursor and fill."""
    rng = np.random.RandomState(4)
    wd, wk = rng.randn(48, 32).astype(np.float32) / 7, rng.randn(48, 32).astype(np.float32) / 7
    xs = [rng.randn(4, 3, 4, 4).astype(np.float32) for _ in range(4)]  # fake, real, fake_aug, real_aug
    head_j = jcl.init_projection_head(jax.random.PRNGKey(1), 32, bilinear=True)
    head_j["bw"] = head_j["bw"] + 0.1 * jnp.asarray(rng.randn(128, 128).astype(np.float32))
    queue = np.zeros((16, 128), np.float32)
    queue[:8] = _unit_rows(8, 128, 5)
    st_j = jcl.ContrastiveState(None, jnp.asarray(queue), jnp.asarray(8, jnp.int32), jnp.asarray(8, jnp.int32))
    hid_j = lambda w: (lambda x: (x.reshape(x.shape[0], -1) @ w).reshape(x.shape[0], 2, 4, 4))  # noqa: E731

    def loss_j(head):
        return jcl.contrastive_regularizer_moco(hid_j(wd), hid_j(wk) if momentum else None, head, st_j, xs[:2], xs[2:],
                                                loss_type=loss_type)

    (want, new_j), want_g = jax.value_and_grad(loss_j, has_aux=True)(head_j)

    head_t = tcl.ProjectionHead(32, bilinear=True)
    head_t.load_state_dict(projection_head_state_dict_from_jax(head_j))
    hid_t = lambda w: (lambda x: (x.reshape(x.shape[0], -1) @ _t(w)).reshape(x.shape[0], 2, 4, 4))  # noqa: E731
    st_t = tcl.ContrastiveState(None, _t(queue), torch.tensor(8), torch.tensor(8))
    got, new_t = tcl.contrastive_regularizer_moco(hid_t(wd), hid_t(wk) if momentum else None, head_t, st_t,
                                                  [_t(x) for x in xs[:2]], [_t(x) for x in xs[2:]], loss_type=loss_type)
    _close(got, want, 1e-6)
    grads = torch.autograd.grad(got, list(head_t.parameters()))
    for (name, _), g in zip(head_t.named_parameters(), grads):
        w = np.asarray(want_g[name])
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max() + 1e-7, name
    _close(new_t.queue, new_j.queue, 1e-6)
    assert int(new_t.queue_ptr) == int(new_j.queue_ptr) and int(new_t.queue_filled) == int(new_j.queue_filled)
    if loss_type == "infonce":
        assert int(new_t.queue_filled) == 16 and int(new_t.queue_ptr) == 0


def test_key_encoder_is_a_copy():
    d = torch.nn.Linear(3, 2)
    st = tcl.init_contrastive_state(d, use_momentum=True, queue_size=4, out_dim=2)
    assert st.key_d is not d and st.queue.shape == (4, 2)
    for a, b in zip(st.key_d.parameters(), copy.deepcopy(d).parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

"""maua_tpu_torch.eval.LPIPS against maua_tpu.eval.lpips on the CPU (vgg and
alex, the same numpy weights from test_torch_port_inference's helpers),
make_perceptual_loss and perceptual_lpips: distances within 1e-5. A file of
its own, so that the JAX LPIPS runs beside the other inference tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.eval.lpips import LPIPS as JaxLPIPS
from maua_tpu.eval.lpips import lpips_variables_from_torch
from maua_tpu_torch.eval import LPIPS, make_perceptual_loss, perceptual_lpips
from maua_tpu_torch.io import lpips_state_dict_from_jax
from test_torch_port_inference import close, heads, torchvision_features


@pytest.mark.parametrize("net", ["vgg", "alex"])
def test_lpips_matches_jax(net):
    """The same backbone and heads (some negative, clamped to 0) in both
    packages; distances within 1e-5. `make_perceptual_loss` is the mean of
    `perceptual_lpips` (heads at ones), and the JAX parameter tree maps back
    through lpips_state_dict_from_jax."""
    backbone, lin = torchvision_features(net), heads(net)
    jv = lpips_variables_from_torch(backbone, lin, net)
    rng = np.random.default_rng(2)
    x, y = (np.tanh(rng.standard_normal((2, 3, 64, 64))).astype(np.float32) for _ in range(2))
    want = np.asarray(JaxLPIPS(net=net).apply(jv, jnp.asarray(x), jnp.asarray(y)))
    got = LPIPS(net).load(backbone, lin)(torch.from_numpy(x), torch.from_numpy(y))
    close(got, want, 1e-5)
    assert (want > 0).all()

    again = LPIPS(net).load(lpips_state_dict_from_jax(jv["params"], net), lpips_state_dict_from_jax(jv["params"], net))
    close(again(torch.from_numpy(x), torch.from_numpy(y)), want, 1e-5)

    ones = {f"lin{i}": np.ones(np.shape(v), np.float32) for i, v in enumerate(jv["params"][f"lin{i}"] for i in range(5))}
    want_pl = np.asarray(JaxLPIPS(net=net).apply({"params": {**jv["params"], **ones}}, jnp.asarray(x), jnp.asarray(y)))
    pl = make_perceptual_loss(backbone, net=net, device="cpu")
    close(pl(torch.from_numpy(x), torch.from_numpy(y)), want_pl.mean(), 1e-5)
    close(perceptual_lpips(backbone, net=net, device="cpu")(torch.from_numpy(x), torch.from_numpy(x)), np.zeros(2), 1e-6)

"""maua_tpu_torch.eval.InceptionV3 against maua_tpu.eval.inception on the CPU,
in both variants at 299^2, batch 1: the JAX network at 299^2 is the slowest
parity check of the port's tests, so it has a file (and an xdist worker) of
its own. The weights are test_torch_port_eval.inception_sd's: fabricated
from a numpy seed in torchvision's layout, loaded by both packages. Features
within 1e-4 of their largest value (94 fp32 convs in two libraries)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.eval.inception import InceptionV3 as JaxInception
from maua_tpu.eval.inception import inception_variables_from_torch
from maua_tpu_torch.eval import InceptionV3
from maua_tpu_torch.io import inception_state_dict_from_jax
from test_torch_port_eval import close, inception_sd


@pytest.mark.parametrize("fid_variant", [False, True])
def test_inception_matches_jax(fid_variant):
    """pool3 features of one 299^2 image in both variants (the A / C / E
    pools count or exclude the padding; Mixed_7c's pool is a max pool in
    pytorch-fid's), and inception_state_dict_from_jax maps the JAX tree back
    onto the same state dict."""
    sd = inception_sd()
    jv = inception_variables_from_torch(sd)
    x = np.tanh(np.random.default_rng(1).standard_normal((1, 3, 299, 299))).astype(np.float32)
    want = np.asarray(jax.jit(JaxInception(fid_variant=fid_variant).apply)(jv, jnp.asarray(x)))
    net = InceptionV3(fid_variant=fid_variant).load(sd).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    scale = float(np.abs(want).max())
    assert scale > 1e-2, "features collapsed"
    close(got / scale, want / scale, 1e-4)

    back = inception_state_dict_from_jax(jv["params"])
    own = {k for k in net.state_dict() if not k.endswith("num_batches_tracked")}
    assert set(back) == own
    for k in back:
        np.testing.assert_array_equal(back[k].numpy(), sd[k])
    with pytest.raises(KeyError, match="missing"):
        InceptionV3().load({k: v for k, v in sd.items() if not k.startswith("Mixed_7c")})



"""maua_tpu_torch's StyleGAN1 against the benchmark's plain reference
(portbench/reference/stylegan1.py, written after NVlabs' G_style) on the CPU,
on seeded random weights whose every bias and noise weight is non-zero: at 32^2
(the nearest-upscale path alone) and at 128^2 (the fused transposed conv from
128^2 too), W+ truncated at 0.7 toward a mean latent, one noise map per block.
The up-conv's bias placement of the JAX package (none on the fused path, before
the zero-padded blur on the other) misses the reference by far more than the
tolerance. Importing the reference loads nothing of JAX or of either package.

Tolerance 1e-4 on images, as the JAX parity tests: fp32 convs in two forms
over 5-7 blocks whose instance norms rescale every layer to unit variance."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_stylegan1 import fabricate_sg1_sd

from maua_tpu_torch.models import StyleGAN1
from maua_tpu_torch.models import stylegan1 as port
from maua_tpu_torch.ops.upfirdn2d import upfirdn2d
from portbench.reference import stylegan1 as ref

TOL = 1e-4


def weights(size: int, seed: int) -> dict:
    """fabricate_sg1_sd with every bias N(0, 0.1^2) and every noise weight N(0, 0.5^2)."""
    sd = fabricate_sg1_sd(size=size, seed=seed)
    rng = np.random.RandomState(seed + 100)
    for k, v in sd.items():
        if k.endswith("noise.weight"):
            sd[k] = (0.5 * rng.randn(*v.shape)).astype(np.float32)
        elif k.endswith("bias"):
            sd[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
    return sd


def port_and_reference_images(size: int, seed: int = 0):
    sd = weights(size, seed)
    model = StyleGAN1.from_state_dict(sd, noise_rng=torch.Generator().manual_seed(seed)).eval()
    p = {k: torch.from_numpy(v) for k, v in sd.items()}
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        w = ref.mapping(p, torch.randn(2, 512, generator=gen))
        wplus = w[:, None].repeat(1, ref.N_LATENT, 1) + 0.3 * torch.randn(2, ref.N_LATENT, 512, generator=gen)
        mean = ref.mean_latent(p, torch.randn(256, 512, generator=gen))
        noise = [torch.randn(2, 1, 4 * 2**i, 4 * 2**i, generator=gen) for i in range(model.num_layers)]
        got = model(wplus, noise=noise, truncation=0.7, truncation_latent=mean)[0]
        want = ref.synthesis(p, ref.truncate(wplus, 0.7, mean), noise, size)
    return got, want


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 4))
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("size", [32, 128])
def test_port_matches_the_reference(size):
    got, want = port_and_reference_images(size)
    assert got.shape == want.shape == (2, 3, size, size)
    assert want.std() > 0.05
    err = float((got - want).abs().max())
    assert err <= TOL, f"max abs {err} > {TOL}"


def _jax_package_placement(self, x):
    """The up-conv as the JAX package computes it: no bias on the fused path,
    the bias before the zero-padded blur below it."""
    w = self.weight * self.w_mul
    if min(x.shape[2:]) * 2 >= 128:
        w = F.pad(w.transpose(0, 1), (1, 1, 1, 1))
        w = w[:, :, 1:, 1:] + w[:, :, :-1, 1:] + w[:, :, 1:, :-1] + w[:, :, :-1, :-1]
        x = F.conv_transpose2d(x, w, stride=2, padding=1)
    else:
        x = F.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), w, self.bias, padding=1)
    return upfirdn2d(x, self.blur, pad=(1, 1))


@pytest.mark.parametrize("size", [32, 128])
def test_the_jax_packages_bias_placement_misses_the_reference(monkeypatch, size):
    monkeypatch.setattr(port._UpConv, "forward", _jax_package_placement)
    got, want = port_and_reference_images(size)
    assert float((got - want).abs().max()) > 100 * TOL


def test_the_reference_imports_neither_package_nor_jax():
    code = ("import sys; import portbench.reference.stylegan1\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'maua_tpu', 'maua_tpu_torch'}))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"

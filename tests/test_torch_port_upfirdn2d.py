"""upfirdn2d's dispatch and the geometry its CUDA kernel takes, on the CPU: a
CPU tensor never launches; every (up, down, pad, taps) that the package's
modules build, and each backward geometry derived from them, is one the
kernel takes (so a new caller outside its range fails here first); what it
refuses; the flip flag of the plain form. The kernel against the plain form
on the card is in test_torch_port_kernels.py. No JAX."""

import importlib
import os
import sys

import pytest
import torch

from maua_tpu_torch.models import Discriminator, Generator, StyleGAN1
from maua_tpu_torch.ops import _build
from maua_tpu_torch.ops.upfirdn2d import (
    backward_geometry,
    kernel_geometry,
    setup_filter,
    upfirdn2d,
    upfirdn2d_kernel,
    upfirdn2d_plain,
)
from maua_tpu_torch.train.augment import apply_affine
from maua_tpu_torch.train.losses import d_r1_penalty

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
fir = importlib.import_module("maua_tpu_torch.ops.upfirdn2d")  # the package exports a function of that name


@pytest.fixture
def recorded(monkeypatch):
    """Every call of the dispatcher, forward and backward: (input shape,
    filter shape, up, down, pad); the kernel library cannot load."""
    calls = []
    plain = fir._upfirdn2d

    def record(x, kernel, up, down, pad, flip):
        calls.append((tuple(x.shape), tuple(kernel.shape), up, down, pad))
        return plain(x, kernel, up, down, pad, flip)

    def no_library(name):
        raise AssertionError(f"the CPU path loaded the {name} library")

    monkeypatch.setattr(fir, "_upfirdn2d", record)
    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(fir, "launches", 0)
    return calls


def _generator_path_penalty():
    """G's forward from W+ and the path penalty's double backward."""
    torch.manual_seed(0)
    g = Generator(size=32, style_dim=16, n_mlp=2, channel_max=16)
    w = torch.randn(2, g.n_latent, 16, requires_grad=True)
    img, _ = g([w], input_is_latent=True, randomize_noise=False)
    (grad,) = torch.autograd.grad((img * torch.randn_like(img)).sum(), w, create_graph=True)
    grad.square().sum().backward()


def _discriminator_r1():
    """D's forward and R1's double backward."""
    torch.manual_seed(0)
    d = Discriminator(size=32, channel_max=16)
    d_r1_penalty(d, torch.randn(2, 3, 32, 32)).backward()


def _ada_conv_warp():
    """ADA's direct warp: SYM6 up 2, the gather, SYM6 down 2, and its backward."""
    img = torch.randn(2, 3, 16, 16, requires_grad=True)
    G = torch.eye(3).repeat(2, 1, 1)
    G[:, 0, 2] = 0.1
    apply_affine(img, G, method="conv").square().sum().backward()


def _stylegan1_forward():
    """StyleGAN1's synthesis at 128^2: the [1, 2, 1] blur after each up-conv,
    nearest (8^2-64^2) and fused (128^2)."""
    torch.manual_seed(0)
    model = StyleGAN1(128, [16] * 6)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_()
        model(torch.randn(2, model.n_latent, model.style_dim))


CALLERS = {"generator": _generator_path_penalty, "discriminator": _discriminator_r1, "ada": _ada_conv_warp,
           "stylegan1": _stylegan1_forward}
# (up, down, taps) of each caller's calls: G's blurs, its skips' Upsample and
# that one's backward; D's blurs alone; ADA's SYM6 up 2 and down 2; StyleGAN1's
# 3-tap blurs
SITES = {
    "generator": {(1, 1, (4, 4)), (2, 1, (4, 4)), (1, 2, (4, 4))},
    "discriminator": {(1, 1, (4, 4))},
    "ada": {(2, 1, (12, 12)), (1, 2, (12, 12))},
    "stylegan1": {(1, 1, (3, 3))},
}


@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_kernel_takes_every_geometry_the_package_builds(recorded, caller):
    """Forward, backward and double backward geometries of each caller, as
    recorded on the CPU, pass the kernel's check; so does the backward of
    each, and the backward of the backward is the geometry itself."""
    CALLERS[caller]()
    assert recorded and fir.launches == 0
    for shape, k_shape, up, down, pad in recorded:
        oh, ow = kernel_geometry(shape, k_shape, up, down, pad)
        b_up, b_down, b_pad = backward_geometry(shape[2:], k_shape, up, down, pad, (oh, ow))
        bh, bw = kernel_geometry(shape[:2] + (oh, ow), k_shape, b_up, b_down, b_pad)
        assert (bh, bw) == shape[2:]
        assert backward_geometry((oh, ow), k_shape, b_up, b_down, b_pad, shape[2:]) == (up, down, pad)
    assert {(up[0], down[0], k_shape) for _, k_shape, up, down, _ in recorded} == SITES[caller]


def test_chip_smokes_stylegan1_sites_are_the_forwards(recorded):
    """chip_smoke times the kernel at StyleGAN1's blur sites: they are the
    calls a full-width forward makes (here at 128^2, batch 2)."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    from maua_tpu_torch.models.stylegan1 import nf

    torch.manual_seed(0)
    model = StyleGAN1(128, [nf(r - 1) for r in range(2, 8)])
    with torch.no_grad():
        model(torch.randn(2, model.n_latent, model.style_dim))
    assert [(shape, (3, 3), (up, up), (down, down), pad)
            for _, shape, _, up, down, pad in chip_smoke.fir_sites_sg1(batch=2, size=128)] == recorded


def test_cpu_tensors_never_launch(recorded):
    """A CPU tensor takes the plain form to any order: the counter stays 0
    and the kernel library is never loaded. Four calls: the forward, its
    backward, and in the double backward that one's backward and the
    forward's backward again (the gradient 2y depends on the output)."""
    x = torch.randn(2, 3, 9, 7, requires_grad=True)
    k = setup_filter([1, 3, 3, 1], gain=4.0)
    y = upfirdn2d(x, k, up=2, pad=(2, 1))
    (g,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    g.square().sum().backward()
    assert fir.launches == 0 and len(recorded) == 4 and x.grad is not None


REFUSED = {
    "up_per_axis": dict(shape=(1, 1, 8, 8), k=(4, 4), up=(1, 2), down=(1, 1), pad=(2, 1, 2, 1), match="same on both"),
    "up_and_down": dict(shape=(1, 1, 8, 8), k=(4, 4), up=(2, 2), down=(2, 2), pad=(1, 1, 1, 1), match="not both"),
    "up_4": dict(shape=(1, 1, 8, 8), k=(4, 4), up=(4, 4), down=(1, 1), pad=(2, 1, 2, 1), match="1 or 2"),
    "13_taps": dict(shape=(1, 1, 32, 32), k=(13, 13), up=(1, 1), down=(1, 1), pad=(6, 6, 6, 6), match="taps"),
    "12_taps_without_resampling": dict(shape=(1, 1, 32, 32), k=(12, 12), up=(1, 1), down=(1, 1), pad=(6, 5, 6, 5),
                                       match="only with up or down 2"),
    "empty": dict(shape=(1, 1, 4, 4), k=(4, 4), up=(1, 1), down=(1, 1), pad=(-2, -2, 0, 0), match="empty"),
    "3d": dict(shape=(1, 8, 8), k=(4, 4), up=(1, 1), down=(1, 1), pad=(1, 1, 1, 1), match=r"\[N, C, H, W\]"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_kernel_geometry_refuses(case):
    c = REFUSED[case]
    with pytest.raises(ValueError, match=c["match"]):
        kernel_geometry(c["shape"], c["k"], c["up"], c["down"], c["pad"])


def test_kernel_geometry_gives_the_plain_forms_shape():
    x = torch.randn(2, 3, 11, 6)
    for up, down, pad in (((1, 1), (1, 1), (1, 1, 1, 1)), ((2, 2), (1, 1), (2, 1, 2, 1)),
                          ((1, 1), (2, 2), (1, 1, -1, 2)), ((2, 2), (1, 1), (-1, 0, 3, -2))):
        want = upfirdn2d_plain(x, torch.ones(3, 4), up, down, pad).shape[2:]
        assert kernel_geometry(tuple(x.shape), (3, 4), up, down, pad) == tuple(want)


def test_plain_flip_is_the_flipped_filter():
    x = torch.randn(2, 3, 8, 6)
    k = torch.arange(12, dtype=torch.float32).reshape(3, 4) / 66
    for up, down in (((1, 1), (1, 1)), ((2, 2), (1, 1)), ((1, 1), (2, 2))):
        got = upfirdn2d_plain(x, k, up, down, (2, 1, 1, 2), flip=True)
        assert torch.equal(got, upfirdn2d_plain(x, torch.flip(k, (0, 1)), up, down, (2, 1, 1, 2)))


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never computes the plain form itself."""
    with pytest.raises(ValueError, match="CUDA"):
        upfirdn2d_kernel(torch.randn(1, 2, 8, 8), setup_filter([1, 3, 3, 1]), pad=(1, 1, 1, 1))

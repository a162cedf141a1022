"""The models' convolution and its derivatives (maua_tpu_torch/ops/conv.py):
float64 gradcheck and gradgradcheck at every geometry that G and D build;
R1 and the path penalty through the small Discriminator and Generator at
32^2 in float64, held to autograd's own conv rule (`F.conv2d` /
`F.conv_transpose2d`), with and without `torch.utils.checkpoint`; which
gradients each backward computes; the `second_order` counter and the
`conv.second_order` span counter. The tests marked `cuda` need a card: one
fp32 R1 chunk and one path-penalty chunk at 256^2, full width, held to
float64 on the card, and a profiled R1 phase free of cuDNN's
`implicit_convolve_sgemm`. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_conv_grad.py -q
"""

from __future__ import annotations

import copy
import json
import sys
import threading

import pytest
import torch
import torch.nn.functional as F
from torch.autograd import gradcheck, gradgradcheck
from torch.utils.checkpoint import checkpoint

from maua_tpu_torch import telemetry
from maua_tpu_torch.models import Discriminator, Generator
from maua_tpu_torch.models.blocks import EqualConv2d, ModulatedConv2d, tf32
from maua_tpu_torch.ops import conv, fused_act
from maua_tpu_torch.train import draw_step, init_train_state, make_train_step
from maua_tpu_torch.train.losses import d_r1_penalty, g_path_length_regularization
from maua_tpu_torch.ops.upfirdn2d import upfirdn2d_plain
from maua_tpu_torch.train.step import _reg_k, make_train_config, synth

F64 = torch.float64
fir = sys.modules["maua_tpu_torch.ops.upfirdn2d"]  # the package exports the function under the module's name

# (name, x shape, w shape, keyword arguments, transposed): the geometries G and D build
GEOMETRIES = [
    ("3x3_pad1", (2, 3, 6, 6), (4, 3, 3, 3), dict(stride=1, padding=1), False),
    ("1x1", (2, 3, 5, 5), (4, 3, 1, 1), dict(stride=1, padding=0), False),
    ("3x3_stride2_after_blur", (2, 3, 9, 9), (4, 3, 3, 3), dict(stride=2, padding=0), False),
    ("1x1_stride2_skip", (2, 3, 8, 8), (4, 3, 1, 1), dict(stride=2, padding=0), False),
    ("3x3_transposed_stride2", (2, 3, 4, 4), (3, 4, 3, 3), dict(stride=2), True),
]
REQUIRES = [(True, False), (False, True), (True, True)]
CASES = [pytest.param(g, r, id=f"{g[0]}-{'x' if r[0] else ''}{'w' if r[1] else ''}") for g in GEOMETRIES for r in REQUIRES]


def _case(geometry, requires):
    _, xs, ws, kw, transposed = geometry
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(xs, generator=gen, dtype=F64).requires_grad_(requires[0])
    w = torch.randn(ws, generator=gen, dtype=F64).requires_grad_(requires[1])
    fn = conv.conv_transpose2d if transposed else conv.conv2d
    return (lambda a, b: fn(a, b, **kw)), x, w


@pytest.mark.parametrize("geometry,requires", CASES)
def test_gradcheck(geometry, requires):
    fn, x, w = _case(geometry, requires)
    assert gradcheck(fn, (x, w))


@pytest.mark.parametrize("geometry,requires", CASES)
def test_gradgradcheck(geometry, requires):
    fn, x, w = _case(geometry, requires)
    assert gradgradcheck(fn, (x, w))


@pytest.mark.parametrize("geometry", [GEOMETRIES[0], GEOMETRIES[4]], ids=lambda g: g[0])
def test_third_order(geometry):
    """The gradient of a create_graph gradient, differentiated twice more."""
    fn, x, w = _case(geometry, (True, True))

    def first(a, b):
        return torch.autograd.grad(fn(a, b).square().sum(), (a, b), create_graph=True)

    assert gradgradcheck(first, (x, w))


# ---------------- R1 and the path penalty through the models ----------------


def _f64(module):
    """The module in float64 throughout: parameters and compute dtype."""
    module = module.double()
    module.dtype = F64
    return module


def _models():
    torch.manual_seed(0)
    d = _f64(Discriminator(size=32, channel_max=32))
    g = _f64(Generator(size=32, style_dim=32, n_mlp=2, channel_max=32, constant_input=True))
    return d, g


def _inputs(g):
    gen = torch.Generator().manual_seed(1)
    return dict(
        img=torch.randn(4, 3, 32, 32, generator=gen, dtype=F64),
        z=torch.randn(2, g.style_dim, generator=gen, dtype=F64),
        noise=[torch.randn(2, 1, s, s, generator=gen, dtype=F64) for s in (4, 8, 8, 16, 16, 32, 32)],
        img_noise=torch.randn(2, 3, 32, 32, generator=gen, dtype=F64),
    )


@pytest.fixture
def autograd_route(monkeypatch):
    """Switch the models' convs to `F.conv2d` / `F.conv_transpose2d` and autograd's own rule."""

    def use():
        monkeypatch.setattr(conv, "conv2d", lambda x, w, stride=1, padding=0: F.conv2d(x, w, stride=stride, padding=padding))
        monkeypatch.setattr(conv, "conv_transpose2d", lambda x, w, stride=1: F.conv_transpose2d(x, w, stride=stride))

    return use


def _r1(d, g, inp, remat=False):
    d_apply = (lambda x: checkpoint(d, x, use_reentrant=False)) if remat else d
    value = d_r1_penalty(d_apply, inp["img"])
    return value, torch.autograd.grad(value, list(d.parameters()), allow_unused=True)


def _path(d, g, inp, remat=False):
    def g_apply(w):
        if remat:
            return checkpoint(lambda w_: synth(g, w_, inp["noise"]), w, use_reentrant=False)
        return synth(g, w, inp["noise"])

    wplus = g.map_latents(inp["z"])  # the mapping network is part of the graph
    mean = torch.zeros((), dtype=wplus.dtype, device=wplus.device)
    value, _, _ = g_path_length_regularization(g_apply, wplus, mean, inp["img_noise"])
    return value, torch.autograd.grad(value, list(g.parameters()), allow_unused=True)


def _assert_close(got, want, rtol=1e-10):
    (v, grads), (v_ref, grads_ref) = got, want
    v, v_ref = float(v.detach()), float(v_ref.detach())
    assert abs(v - v_ref) <= rtol * abs(v_ref)
    assert [g is None for g in grads] == [g is None for g in grads_ref]
    reached = [(a, b) for a, b in zip(grads, grads_ref) if b is not None]
    assert reached
    for a, b in reached:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert float((a - b).norm()) <= rtol * float(b.norm()), (float((a - b).norm()), float(b.norm()))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "checkpoint"])
@pytest.mark.parametrize("regularizer", [_r1, _path], ids=["r1", "path"])
def test_regularizer_matches_autograds_conv_rule(regularizer, remat, autograd_route):
    d, g = _models()
    inp = _inputs(g)
    n0 = conv.second_order
    got = regularizer(d, g, inp, remat)
    n1 = conv.second_order
    assert n1 > n0
    autograd_route()
    want = regularizer(d, g, inp, False)
    assert conv.second_order == n1  # autograd's own rule counts nothing
    _assert_close(got, want)


def _recording_masks(monkeypatch):
    masks = []
    real = conv._backward

    def record(gy, x, w, geometry, mask):
        masks.append(tuple(mask))
        return real(gy, x, w, geometry, mask)

    monkeypatch.setattr(conv, "_backward", record)
    return masks


def test_backwards_compute_only_the_gradients_they_use(monkeypatch):
    """R1's first backward, and a backward through D to G's parameters, take no
    weight gradient of D, as autograd's own conv node takes none; R1's second
    backward takes D's weight terms as wgrads."""
    d, g = _models()
    inp = _inputs(g)
    n_d = sum(isinstance(m, EqualConv2d) for m in d.modules())
    n_g = sum(isinstance(m, ModulatedConv2d) for m in g.modules())
    masks = _recording_masks(monkeypatch)
    img = inp["img"].clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(d(img).sum(), img, create_graph=True)
    assert masks == [(True, False)] * n_d  # dgrad alone

    masks.clear()
    torch.autograd.grad(grad.square().sum(), list(d.parameters()), allow_unused=True)
    # each conv's weight term, a wgrad; and, as under autograd's own rule, each
    # forward conv's node once more, reached through the activations, whose
    # Function makes zeros of the undefined gradient it is handed
    assert sorted(masks) == sorted([(False, True)] * n_d + [(True, True)] * n_d)

    masks.clear()
    fake = synth(g, g.map_latents(inp["z"]), inp["noise"])
    torch.autograd.grad(F.softplus(-d(fake)).mean(), list(g.parameters()))
    assert sorted(masks) == sorted([(True, False)] * n_d + [(True, True)] * n_g)


# ---------------- the counters ----------------


@pytest.mark.parametrize("transposed", [False, True], ids=["conv2d", "conv_transpose2d"])
def test_no_grad_forward_is_the_functional_call(transposed):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 9, 9, generator=gen, requires_grad=True)
    w = torch.randn(8, 6, 3, 3, generator=gen, requires_grad=True)
    n0 = conv.second_order
    with torch.no_grad():
        if transposed:
            got, want = conv.conv_transpose2d(x, w, stride=2), F.conv_transpose2d(x, w, stride=2)
        else:
            got, want = conv.conv2d(x, w.transpose(0, 1), padding=1), F.conv2d(x, w.transpose(0, 1), padding=1)
    assert got.grad_fn is None and torch.equal(got, want)
    assert conv.second_order == n0


def test_plain_backward_counts_no_second_order():
    d, _ = _models()
    img = torch.randn(4, 3, 32, 32, dtype=F64)
    n0 = conv.second_order
    grads = torch.autograd.grad(F.softplus(d(img)).mean(), list(d.parameters()))
    assert all(g is not None for g in grads)
    assert conv.second_order == n0


def test_one_r1_counts_each_of_ds_convs_once():
    d, g = _models()
    n_convs = sum(isinstance(m, EqualConv2d) for m in d.modules())
    assert n_convs == 11  # from_rgb, 3 ResBlocks of 3, final_conv
    n0 = conv.second_order
    _r1(d, g, _inputs(g))
    assert conv.second_order - n0 == n_convs


def test_count_reaches_a_span_from_another_thread():
    """A CUDA backward runs on autograd's own thread, where no span is open:
    `count(..., span=current_span())` still lands in the span."""
    telemetry.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with telemetry.phase("outer"):
            with telemetry.phase("inner"):
                span = telemetry.current_span()
                t = threading.Thread(target=lambda: (telemetry.count("things"), telemetry.count("things", 2, span=span)))
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
    rec = telemetry.recorded()
    telemetry.reset()
    assert rec["inner"]["counters"] == {"things": 2} and rec["outer"]["counters"] == {"things": 2}
    assert telemetry.current_span() is None


def test_train_step_counts_second_order_under_r1_and_path_alone():
    cfg = make_train_config(size=16, batch_size=4, channel_max=16, latent_dim=16, augment=False, lookahead=False)
    state = init_train_state(cfg, 0, "cpu")
    real = torch.randint(0, 256, (1, 4, 16, 16, 3), dtype=torch.uint8)
    draws = draw_step(cfg, state.step, torch.Generator().manual_seed(0), "cpu")  # step 0: R1 and the path penalty
    n_d = sum(isinstance(m, EqualConv2d) for m in state.d.modules())
    n_g = sum(isinstance(m, ModulatedConv2d) for m in state.g.modules())
    telemetry.reset()
    n0 = conv.second_order
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        make_train_step(cfg)(state, real, draws)
        with telemetry.phase("render"), torch.no_grad():
            state.g_ema(torch.randn(2, 16))
    rec = telemetry.recorded()
    telemetry.reset()
    counted = {name: s["counters"].get("conv.second_order", 0) for name, s in rec.items()}
    assert counted["train_step.r1"] == n_d * _reg_k(cfg)
    assert counted["train_step.path"] == n_g * _reg_k(cfg)
    assert counted["train_step"] == conv.second_order - n0 == counted["train_step.r1"] + counted["train_step.path"]
    assert counted["train_step.d"] == counted["train_step.g"] == counted["render"] == 0


# ---------------- on the card ----------------


def _card_models():
    torch.manual_seed(0)
    d = Discriminator(size=256, channel_multiplier=2, channel_max=512).cuda()
    g = Generator(size=256, channel_multiplier=2, channel_max=512, constant_input=True).cuda()
    return d, g


def _card_inputs(g):
    gen = torch.Generator(device="cuda").manual_seed(5)
    sizes = [4] + [2**i for i in range(3, 9) for _ in (0, 1)]
    return dict(
        img=torch.randn(4, 3, 256, 256, generator=gen, device="cuda"),
        z=torch.randn(2, g.style_dim, generator=gen, device="cuda"),
        noise=[torch.randn(2, 1, s, s, generator=gen, device="cuda") for s in sizes],
        img_noise=torch.randn(2, 3, 256, 256, generator=gen, device="cuda"),
    )


@pytest.fixture
def float64_plain_forms(monkeypatch):
    """float64 CUDA tensors take the plain forms of the hand-written kernels,
    which take fp32 and bf16 alone."""

    def route(kernel, plain):
        return lambda x, *a: (plain if x.dtype == F64 else kernel)(x, *a)

    monkeypatch.setattr(fused_act, "fused_bias_act", route(fused_act.fused_bias_act, fused_act.fused_leaky_relu_plain))
    monkeypatch.setattr(fused_act, "fused_bias_act_grad",
                        route(fused_act.fused_bias_act_grad, fused_act.fused_bias_act_grad_plain))
    monkeypatch.setattr(fir, "_upfirdn2d", route(fir._upfirdn2d, upfirdn2d_plain))


def _rel_err(grads, ref) -> list[float]:
    return [float((a.double() - b).norm() / b.norm()) for a, b in zip(grads, ref) if b is not None and b.norm() > 0]


@pytest.mark.cuda
@pytest.mark.parametrize("regularizer", [_r1, _path], ids=["r1", "path"])
def test_card_regularizer_gradients_against_float64(regularizer, autograd_route, float64_plain_forms):
    """One fp32, TF32-off chunk at 256^2, full width: the gradients of D (R1) or
    G (the path penalty) on this route are no further from float64 than those
    of autograd's own rule, parameter by parameter in the mean and at worst."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: cuDNN's fp32 convolutions")
    d, g = _card_models()
    inp = _card_inputs(g)
    with tf32(conv=False, matmul=False):
        new = regularizer(d, g, inp)[1]
        d64, g64 = _f64(copy.deepcopy(d)), _f64(copy.deepcopy(g))
        inp64 = {k: [t.double() for t in v] if isinstance(v, list) else v.double() for k, v in inp.items()}
        ref = regularizer(d64, g64, inp64)[1]
        autograd_route()
        old = regularizer(d, g, inp)[1]
    err_new, err_old = _rel_err(new, ref), _rel_err(old, ref)
    print(json.dumps(dict(test=regularizer.__name__, err_new=err_new, err_old=err_old)))
    assert len(err_new) == len(err_old) > 0
    mean_new, mean_old = sum(err_new) / len(err_new), sum(err_old) / len(err_old)
    assert mean_new <= 1.25 * mean_old and max(err_new) <= 1.25 * max(err_old), (mean_new, mean_old)


@pytest.mark.cuda
def test_card_r1_phase_launches_no_implicit_convolve_sgemm():
    """Inside `train_step.r1` of a 256^2 full-width step, no kernel of cuDNN's
    fallback `implicit_convolve_sgemm`: the double backward's weight term is a
    wgrad. The count of `conv.second_order` is D's convs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: cuDNN's kernels")
    dev = torch.device("cuda")
    cfg = make_train_config(size=256, batch_size=4, channel_multiplier=2, channel_max=512, augment=False,
                            lookahead=False)
    state = init_train_state(cfg, 0, dev)
    real = torch.randint(0, 256, (1, 4, 256, 256, 3), dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    step_fn = make_train_step(cfg)
    step_fn(state, real, draw_step(cfg, 0, gen, dev))  # warm-up: builds the kernels
    state.step = 0
    draws = draw_step(cfg, 0, gen, dev)
    torch.cuda.synchronize()
    telemetry.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step_fn(state, real, draws)
        torch.cuda.synchronize()
    rec = telemetry.recorded()
    telemetry.reset()
    events = list(prof.events())
    (r1,) = [e for e in events if e.name == "train_step.r1" and str(e.device_type).endswith("CPU")]
    inside = [e for e in events if r1.time_range.start <= e.time_range.start <= r1.time_range.end]
    kernels = [k.name for e in inside for k in e.kernels]
    assert kernels and any("wgrad" in k or "dgrad" in k or "gemm" in k for k in kernels)
    assert not [k for k in kernels if "implicit_convolve_sgemm" in k]
    n_d = sum(isinstance(m, EqualConv2d) for m in state.d.modules())
    assert rec["train_step.r1"]["counters"].get("conv.second_order") == n_d * _reg_k(cfg)
    assert rec["train_step.path"]["counters"].get("conv.second_order", 0) > 0

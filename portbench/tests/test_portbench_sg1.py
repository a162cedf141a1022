"""The StyleGAN1 cell's harness on the CPU: the render_sg1 driver at 32^2
through `execute` is correct and catches the JAX package's bias placement;
the four readers on a hand-made recorder and trace, and None without a trace
or on a program without the spans; work_sg1's counts against a count by hand;
the configuration's widths and size."""

from __future__ import annotations

import math

import pytest
import torch
import torch.nn.functional as F

from maua_tpu_torch import telemetry
from maua_tpu_torch.models import stylegan1 as port
from maua_tpu_torch.ops.upfirdn2d import upfirdn2d
from portbench import common, work_sg1
from portbench.drivers.render_sg1 import leaves
from portbench.run import execute

SEED = 3_000_000_019
CELL = "sg1-ffhq1024.render"
NEW = ["adain_share.sg1.render", "upscale_share.sg1.render", "upfirdn2d_roofline.sg1.render", "host_syncs.sg1.render"]


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 4))
    yield
    torch.set_num_threads(old)


def tiny() -> common.Cell:
    """The cell at 32^2 with 32 channels and a few frames."""
    cell = common.find_cell(CELL)
    cell.config = dict(cell.config, size=32, channels=[32] * 4)
    cell.traffic = dict(cell.traffic, frames=12, batch=4, clips=2, keyframe_every=4, noise_max_width=16,
                        mean_latent_z=256, judged_per_call=3)
    return cell


def test_driver_runs_and_is_correct():
    out = execute(tiny(), SEED, 0.5, False, device="cpu")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"render_fps", "setup_s"} and set(out["checks"]) == {"mismatch_share"}
    assert out["attempted"] > 0 and out["failed"] == 0


def test_fault_the_jax_packages_bias_placement(monkeypatch):
    """The up-conv's bias before the zero-padded blur (the JAX package's
    placement on the nearest path, the only one at 32^2)."""

    def before_blur(self, x):
        x = F.conv2d(F.interpolate(x, scale_factor=2, mode="nearest"), self.weight * self.w_mul, self.bias, padding=1)
        return upfirdn2d(x, self.blur, pad=(1, 1))

    monkeypatch.setattr(port._UpConv, "forward", before_blur)
    assert not execute(tiny(), SEED, 0.5, False, device="cpu")["correct"]


def _span(count, host_s, device_ms=None, **counters):
    return {"count": count, "host_s": host_s, "device_ms": device_ms, "counters": counters}


RECORDED = {
    "render": _span(2, 4.0),
    "sg1.synthesis": _span(10, 1.0, 1000.0, **{"cuda.syncs": 80}),
    "sg1.up": _span(80, 0.2, 150.0, **{"cuda.syncs": 80}),
    "sg1.epilogue": _span(180, 0.5, 400.0),
}
KERNEL = "void (anonymous namespace)::upfirdn2d_kernel<float, 4, 1>((anonymous namespace)::Geom)"


def _ctx(trace=True):
    t = {"kernel_s": {KERNEL: 2.0, "sgemm": 5.0}, "busy_s": 9.0, "window_s": 10.0} if trace else None
    return {"cell": common.find_cell(CELL), "trace": t, "spans": {}, "window_s": 10.0,
            "work": {"flops": 1e12, "upfirdn2d_bytes": 3.35e12}}


def test_new_metrics_are_listed_for_the_cell_alone():
    assert set(NEW) <= {m["name"] for m in common.find_cell(CELL).per_layer}
    for other in ("ffhq1024.render", "sg2-256.train", "ffhq1024.train"):
        assert not set(NEW) & {m["name"] for m in common.find_cell(other).per_layer}


def test_readers_on_a_hand_made_recorder_and_trace(monkeypatch):
    monkeypatch.setattr(telemetry, "recorded", lambda: RECORDED)
    got = {name: common.reader(name)(_ctx()) for name in NEW}
    assert got == pytest.approx({"adain_share.sg1.render": 40.0, "upscale_share.sg1.render": 15.0,
                                 "upfirdn2d_roofline.sg1.render": 50.0, "host_syncs.sg1.render": 8.0})
    assert common.reader("mfu.render")(_ctx()) == pytest.approx(100.0 * 1e12 / 10.0 / 67e12)


@pytest.mark.parametrize("case", ["no trace", "no spans", "no recorder", "untimed spans"])
def test_nothing_to_read_gives_none(monkeypatch, case):
    ctx = _ctx(trace=case != "no trace")
    if case == "no trace":
        monkeypatch.setattr(telemetry, "recorded", lambda: RECORDED)
    elif case == "no spans":  # a program from before the spans: the parent of the change that added them
        monkeypatch.setattr(telemetry, "recorded", lambda: {"render": RECORDED["render"]})
        ctx["trace"]["kernel_s"] = {"conv_depthwise2d_forward_kernel": 1.0}
    elif case == "no recorder":
        monkeypatch.delattr(telemetry, "recorded")
        ctx["trace"]["kernel_s"] = {"sgemm": 1.0}
    else:
        monkeypatch.setattr(telemetry, "recorded", lambda: {k: dict(v, device_ms=None) for k, v in RECORDED.items()})
    got = {name: common.reader(name)(ctx) for name in NEW}
    if case == "untimed spans":  # the counter needs no timing, and the trace still reads
        assert got == {"adain_share.sg1.render": None, "upscale_share.sg1.render": None,
                       "upfirdn2d_roofline.sg1.render": pytest.approx(50.0), "host_syncs.sg1.render": 8.0}
    else:
        assert got == dict.fromkeys(NEW)


def test_work_at_32_by_hand():
    cfg = tiny().config
    s, c = 512, 32
    style = 2 * s * 2 * c  # the two epilogues' style linears, a block
    macs = 16 * c * c * 9 + style  # 4^2: conv
    for r in (8, 16, 32):
        macs += r * r * c * c * 9 + r * r * c * 9 + r * r * c * c * 9 + style  # nearest + conv, blur, conv1
    macs += 32 * 32 * c * 3  # torgb
    assert work_sg1.frame_flops(cfg) == 2 * macs == 2 * 25_667_584
    assert work_sg1.blur_bytes(cfg) == 2 * 4 * c * (8 * 8 + 16 * 16 + 32 * 32) == 344_064
    # fused from 16^2: 16^2 and 32^2 through the transposed conv, (r/2)^2 x in x out x 16
    fused = 2 * (macs - (16 * 16 + 32 * 32) * c * c * 9 + (8 * 8 + 16 * 16) * c * c * 16)
    assert work_sg1.frame_flops(cfg, fused_from=16) == fused


def test_configuration_widths_and_size():
    cfg = common.find_cell(CELL).config
    nf = [min(int(cfg["fmap_base"] / 2.0**stage), cfg["fmap_max"]) for stage in range(1, 10)]
    assert cfg["channels"] == nf == [512, 512, 512, 512, 256, 128, 64, 32, 16]
    params = sum(math.prod(shape) for key, shape, _ in leaves(cfg) if not key.startswith("noises."))
    assert params == 26_212_019

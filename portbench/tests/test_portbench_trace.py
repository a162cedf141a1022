"""The reduction of a profiler trace and the per-layer readers, on a CPU
profile and on hand-made traces (device times come only from a card)."""

from __future__ import annotations

import math

import pytest
import torch

from portbench import common, trace
from portbench.trace import _label_gaps


def test_reduce_cpu_profile_finds_the_window():
    spans = common.Spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans("window"):
            with spans("data"):
                torch.randn(64, 64) @ torch.randn(64, 64)
    r = trace.reduce(prof)
    assert r["busy_s"] == 0.0 and r["window_s"] > 0 and r["kernel_s"] == {}
    assert r["idle_gaps"][0][0].startswith("data > ")
    assert math.isclose(sum(v for _, v in r["idle_gaps"]), r["window_s"], rel_tol=1e-6)
    assert spans.seconds["data"] and spans.seconds["window"]


def test_gap_labels_follow_the_innermost_span_and_op():
    cpu = [(0, 100, "portbench.window"), (10, 50, "portbench.data"), (20, 30, "aten::copy_"),
           (60, 90, "portbench.step.plain")]
    out = _label_gaps([(22, 28), (40, 45), (70, 80), (95, 99)], cpu)
    assert out == pytest.approx({"data > aten::copy_": 6e-9, "data > python": 5e-9, "step.plain > python": 10e-9,
                                 "window > python": 4e-9})


def _ctx(cell_name, kernel_s, busy, window, work, spans=None):
    cell = common.find_cell(cell_name)
    t = {"kernel_s": kernel_s, "busy_s": busy, "window_s": window}
    return {"cell": cell, "trace": t, "spans": spans or {}, "window_s": window, "work": work}


def test_readers_on_a_hand_made_trace():
    k = {"void (anonymous namespace)::fused_bias_act_kernel<float, 4, unsigned int>(float const*)": 0.5,
         "void fused_bias_act_grad_kernel<float, 4>(float const*)": 1.0,
         "void regular_fft<...>": 0.25, "fft2d_r2c_32x32": 0.25, "sgemm": 8.0}
    work = {"flops": 67e12 * 10 * 0.3, "fused_bias_act_bytes": 0.4 * 3.35e12,
            "fused_bias_act_grad_bytes": 0.9 * 3.35e12, "peak_mem_bytes": 3 * 2**30}
    spans = {"data": [0.5, 0.5], "step.reg": [0.1], "step.plain": [0.1, 0.1],
             "device.step.reg": [2.0], "device.step.plain": [0.5, 0.7]}
    ctx = _ctx("sg2-256.train", k, 9.0, 10.0, work, spans)
    read = {m["name"]: common.reader(m["name"])(ctx) for m in ctx["cell"].per_layer}
    assert read["idle_share.train"] == pytest.approx(10.0)
    assert read["mfu.train"] == pytest.approx(30.0)
    assert read["fused_bias_act_roofline.train"] == pytest.approx(80.0)
    assert read["fused_bias_act_grad_roofline.train"] == pytest.approx(90.0)
    assert read["data_wait_share.train"] == pytest.approx(10.0)
    assert read["step_ms.reg.train"] == pytest.approx(2000.0)
    assert read["step_ms.plain.train"] == pytest.approx(600.0)
    assert read["peak_mem_gib.train"] == pytest.approx(3.0)


def test_readers_with_nothing_to_read_return_none():
    ctx = _ctx("ffhq1024.render", {"sgemm": 1.0}, 1.0, 2.0, {"flops": 1.0})
    assert common.reader("fused_bias_act_roofline.render")(ctx) is None
    ctx["trace"] = None
    for m in ctx["cell"].per_layer:
        assert common.reader(m["name"])(ctx) is None

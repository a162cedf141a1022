"""The `fir_share.*` readers on hand-made traces: they read the FIR pass
under either kernel's name, and nothing without one."""

from __future__ import annotations

import pytest

from portbench import common

DEPTHWISE = ("void at::native::(anonymous namespace)::conv_depthwise2d_forward_kernel<0, float, int>"
             "(at::GenericPackedTensorAccessor<float const, 4ul>)")
KERNEL = "void (anonymous namespace)::upfirdn2d_kernel<float, 1, 1, 4>((anonymous namespace)::Geom)"


def _ctx(cell_name, kernel_s):
    cell = common.find_cell(cell_name)
    trace = {"kernel_s": kernel_s, "busy_s": sum(kernel_s.values()), "window_s": 10.0}
    return {"cell": cell, "trace": trace, "spans": {}, "window_s": 10.0, "work": {}}


@pytest.mark.parametrize("metric,cell", [("fir_share.render", "ffhq1024.render"), ("fir_share.train", "sg2-256.train"),
                                         ("fir_share.train", "ffhq1024.train")])
@pytest.mark.parametrize("name", [DEPTHWISE, KERNEL])
def test_fir_share_reads_either_kernel(metric, cell, name):
    ctx = _ctx(cell, {name: 1.0, "sm80_xmma_fprop_implicit_gemm": 6.0, "elementwise_kernel": 3.0})
    assert metric in {m["name"] for m in ctx["cell"].per_layer}
    assert common.reader(metric)(ctx) == pytest.approx(10.0)


@pytest.mark.parametrize("metric,cell", [("fir_share.render", "ffhq1024.render"), ("fir_share.train", "sg2-256.train")])
def test_fir_share_without_the_pass_or_a_trace_is_none(metric, cell):
    ctx = _ctx(cell, {"sm80_xmma_fprop_implicit_gemm": 6.0, "elementwise_kernel": 3.0})
    assert common.reader(metric)(ctx) is None
    ctx["trace"] = None
    assert common.reader(metric)(ctx) is None

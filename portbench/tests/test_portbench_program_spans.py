"""The readers of the program's own spans and counters, on a hand-made
recorder (`maua_tpu_torch.telemetry.recorded()` replaced) and on a program
without one, which has nothing to read."""

from __future__ import annotations

import pytest

from maua_tpu_torch import telemetry
from portbench import common

NEW = ["phase_ms.d.train", "phase_ms.r1.train", "phase_ms.g.train", "phase_ms.path.train", "host_syncs.train",
       "loader_wait_ms.train", "loader_assemble_ms.train", "render_edges_ms.render", "render_enqueue_ms.render"]


def _span(count, host_s, device_ms=None, **counters):
    return {"count": count, "host_s": host_s, "device_ms": device_ms, "counters": counters}


RECORDED = {
    "train_step": _span(16, 8.0, 8000.0, **{"cuda.syncs": 40}),
    "train_step.d": _span(16, 2.0, 3200.0, **{"cuda.syncs": 8}),
    "train_step.r1": _span(1, 0.1, 150.0),
    "train_step.g": _span(16, 2.0, 2400.0, **{"cuda.syncs": 32}),
    "train_step.path": _span(4, 0.5, 1000.0),
    "data": _span(16, 0.8, **{"data.starved": 2}),
    "data.wait": _span(16, 0.32),
    "data.assemble": _span(16, 0.48),
    "render": _span(4, 12.0),
    "render.prepare": _span(4, 0.4),
    "render.stage": _span(4, 0.2),
    "render.finish": _span(4, 0.2),
    "render.batch": _span(152, 3.04),
    "render.fetch": _span(152, 8.0),
}


def _ctx(cell_name):
    cell = common.find_cell(cell_name)
    t = {"kernel_s": {"sgemm": 1.0}, "busy_s": 9.0, "window_s": 10.0}
    return {"cell": cell, "trace": t, "spans": {}, "window_s": 10.0, "work": {}}


def _read(ctx):
    return {m["name"]: common.reader(m["name"])(ctx) for m in ctx["cell"].per_layer}


def test_new_metrics_are_listed_for_their_cells():
    for cell, names in (("sg2-256.train", NEW[:7]), ("ffhq1024.train", NEW[:7]), ("ffhq1024.render", NEW[7:])):
        listed = {m["name"] for m in common.find_cell(cell).per_layer}
        assert set(names) <= listed and not (set(NEW) - set(names)) & listed


def test_readers_on_a_hand_made_recorder(monkeypatch):
    monkeypatch.setattr(telemetry, "recorded", lambda: RECORDED)
    train = _read(_ctx("sg2-256.train"))
    assert train["phase_ms.d.train"] == pytest.approx(200.0)
    assert train["phase_ms.r1.train"] == pytest.approx(150.0)
    assert train["phase_ms.g.train"] == pytest.approx(150.0)
    assert train["phase_ms.path.train"] == pytest.approx(250.0)
    assert train["host_syncs.train"] == pytest.approx(2.5)
    assert train["loader_wait_ms.train"] == pytest.approx(20.0)
    assert train["loader_assemble_ms.train"] == pytest.approx(30.0)
    render = _read(_ctx("ffhq1024.render"))
    assert render["render_edges_ms.render"] == pytest.approx(200.0)
    assert render["render_enqueue_ms.render"] == pytest.approx(20.0)


def test_a_step_without_syncs_reads_zero(monkeypatch):
    monkeypatch.setattr(telemetry, "recorded", lambda: {"train_step": _span(3, 1.0, 900.0)})
    assert common.reader("host_syncs.train")(_ctx("sg2-256.train")) == 0.0
    assert common.reader("phase_ms.d.train")(_ctx("sg2-256.train")) is None


@pytest.mark.parametrize("case", ["no trace", "empty recorder", "no recorder", "untimed spans"])
def test_nothing_to_read_gives_none(monkeypatch, case):
    ctx = _ctx("sg2-256.train")
    if case == "no trace":
        monkeypatch.setattr(telemetry, "recorded", lambda: RECORDED)
        ctx["trace"] = None
    elif case == "empty recorder":
        monkeypatch.setattr(telemetry, "recorded", dict)
    elif case == "no recorder":  # a program from before the recorder: the parent of the change that added it
        monkeypatch.delattr(telemetry, "recorded")
    else:
        monkeypatch.setattr(telemetry, "recorded", lambda: {"train_step.d": _span(2, 1.0)})
    for name in NEW[:7]:
        assert common.reader(name)(ctx) is None, name
    if case != "untimed spans":
        ctx = dict(_ctx("ffhq1024.render"), trace=ctx["trace"])
        for name in NEW[7:]:
            assert common.reader(name)(ctx) is None, name

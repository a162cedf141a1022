"""The drivers' control flow at a tiny size on the CPU, through `execute`,
the test-only entry that returns the result instead of printing it; and the
faults that the comparison has to catch, planted in the program's timed
path, each coming out as not correct."""

from __future__ import annotations

import math

import pytest
import torch

from portbench.drivers import train as train_driver
from portbench.run import execute, limits
from portbench.tests.tiny import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
SEED = 3_000_000_019  # above 2^31: seeds need not fit 32 signed bits


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 4))
    yield
    torch.set_num_threads(old)


def _run(name: str) -> dict:
    return execute(tiny(name), SEED, 0.5, False, device="cpu")


@pytest.mark.parametrize("name", ["ffhq1024.render", "sg2-256.train", "ffhq1024.train"])
def test_result_line_keys_and_metrics(name):
    out = _run(name)
    assert list(out) == KEYS  # the numbers compared come last
    cell = tiny(name)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in out["metrics"].values():
        assert m["value"] > 0 and math.isfinite(m["value"])
    assert out["attempted"] > 0 and out["failed"] == 0
    if cell.traffic["driver"] == "train":  # whole cycles of R1 every 16 and the path penalty every 4
        assert out["attempted"] % 16 == 0
    assert set(out["checks"]) == set(limits(name))
    assert all(math.isfinite(c["value"]) for c in out["checks"].values())


def test_render_sound_run_is_correct():
    out = _run("ffhq1024.render")
    assert out["correct"], out["checks"]


def test_fault_altered_frame(monkeypatch):
    """An answer altered where it is produced: every frame packed with red and blue swapped."""
    import maua_tpu_torch.render.frames as frames

    real = frames._pack_frames

    def altered(img, out_size):
        return real(img, out_size).flip(-1).contiguous()

    monkeypatch.setattr(frames, "_pack_frames", altered)
    assert not _run("ffhq1024.render")["correct"]


def test_fault_state_unchanged(monkeypatch):
    """A step that returns its state unchanged: no optimizer step lands."""
    import maua_tpu_torch.train.step as step

    monkeypatch.setattr(step, "_apply", lambda optim, params, grads: None)
    out = _run("sg2-256.train")
    assert not out["correct"]
    assert out["checks"]["change_gap"]["value"] >= 0.99


def test_fault_half_batch(monkeypatch):
    """Half of the batch left out of every loss, the mean taken over the rest."""
    import maua_tpu_torch.train.step as step

    d_loss, g_loss = step.d_logistic_loss, step.g_nonsaturating_loss
    monkeypatch.setattr(step, "d_logistic_loss", lambda r, f: d_loss(r[: len(r) // 2], f[: len(f) // 2]))
    monkeypatch.setattr(step, "g_nonsaturating_loss", lambda f: g_loss(f[: len(f) // 2]))
    assert not _run("sg2-256.train")["correct"]


def test_reference_control_and_half_batch_in_its_place():
    """The reference put in the program's place with half of each batch left
    out reads far above the limits; the program's own gaps are finite."""
    cell = tiny("sg2-256.train")
    state = train_driver.setup(cell, SEED, "cpu")
    train_driver.release(state)
    lim = limits("sg2-256.train")
    fault = train_driver.control(state, "half_batch")
    assert any(fault[k] > lim[k] for k in lim)
    same = train_driver.compare(train_driver.reference(state, train_driver.matched_reals(state)[0]),
                                train_driver.reference(state, train_driver.matched_reals(state)[0]),
                                state.gw, state.dw)
    assert all(v == 0.0 for k, v in same.items())

"""The program's spans and counters (maua_tpu_torch/telemetry/profiling.py):
nothing is recorded while no profiler records; under a CPU torch.profiler a
train step, a `next(loader)` and a `render()` record their spans with their
parents and request ids, in the exported chrome trace and in spans.json.
The last test needs a card (marked `cuda`): the phases' device time and the
count of a deliberate `.item()`. This file imports no JAX, so it also runs
on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_tracing.py -q
"""

from __future__ import annotations

import json
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import maua_tpu_torch.render.frames as frames_mod
from maua_tpu_torch import telemetry
from maua_tpu_torch.data import DataLoader
from maua_tpu_torch.models import Generator
from maua_tpu_torch.train import draw_step, init_train_state, make_train_step
from maua_tpu_torch.train.step import make_train_config

PHASES = ["train_step.d", "train_step.r1", "train_step.ada", "train_step.g", "train_step.path", "train_step.tail"]


@pytest.fixture(autouse=True)
def _clean():
    telemetry.reset()
    yield
    telemetry.reset()


def _profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _records(log_dir) -> list[dict]:
    return json.load(open(log_dir / "spans.json"))["records"]


def _train(device="cpu"):
    cfg = make_train_config(size=16, batch_size=4, channel_max=16, latent_dim=16, augment=False, lookahead=False)
    state = init_train_state(cfg, 0, device)
    real = torch.randint(0, 256, (1, 4, 16, 16, 3), dtype=torch.uint8, device=device)
    draws = draw_step(cfg, state.step, torch.Generator(device=device).manual_seed(0), device)
    return cfg, state, make_train_step(cfg), real, draws


class _Records:
    """Records of 16x16 uint8 images; `gate` holds the workers back until set."""

    uint8_hwc = True

    def __init__(self, n=8):
        self.n, self.gate = n, threading.Event()

    def __len__(self):
        return self.n

    def iter_indices(self, seed=0):
        while True:
            yield from range(self.n)

    def __getitem__(self, i):
        self.gate.wait(10.0)
        return np.full((16, 16, 3), i, np.uint8)


def _sink(frames):
    class Sink:
        def __init__(self, output_file, width, height, fps, **kw):
            pass

        def write(self, frame):
            frames.append(frame)

        def close(self):
            pass

    return Sink


def _render(monkeypatch, tmp_path, n_frames=5, batch_size=2):
    gen = Generator(size=16, style_dim=16, n_mlp=1, channel_max=16, constant_input=True).eval()
    latents = np.random.RandomState(0).randn(n_frames, gen.n_latent, 16).astype(np.float32)
    out = []
    monkeypatch.setattr(frames_mod, "VideoWriter", _sink(out))
    frames_mod.render(gen, None, latents, [], str(tmp_path / "x.mp4"), batch_size=batch_size, device="cpu")
    assert len(out) == n_frames
    return out


def test_off_records_nothing_and_phase_is_the_shared_no_op(monkeypatch, tmp_path):
    assert not torch.autograd._profiler_enabled()
    assert telemetry.phase("a") is telemetry.phase("b", request=3, device=torch.device("cpu"))
    with telemetry.phase("a"):
        telemetry.count("c")
    _, state, step_fn, real, draws = _train()
    step_fn(state, real, draws)
    data = _Records()
    data.gate.set()
    loader = DataLoader(data, batch_size=4, num_workers=1, device="cpu")
    try:
        next(loader)
    finally:
        loader.close()
    _render(monkeypatch, tmp_path)
    assert telemetry.recorded() == {}


def test_train_step_records_its_phases_in_order(tmp_path):
    _, state, step_fn, real, draws = _train()  # step 0: R1 and the path penalty are due
    with telemetry.profile_trace(str(tmp_path)):
        step_fn(state, real, draws)
    recs = _records(tmp_path)
    assert [r["name"] for r in recs] == PHASES + ["train_step"]  # in the order they closed
    assert all(r["request"] == 0 for r in recs)
    assert [r["parent"] for r in recs] == ["train_step"] * 6 + [None]
    top = recs[-1]
    for r in recs[:-1]:
        assert top["start_ns"] <= r["start_ns"] <= r["end_ns"] <= top["end_ns"]
    for a, b in zip(recs[:5], recs[1:6]):
        assert a["end_ns"] <= b["start_ns"]
    assert all(r["device_ms"] is None for r in recs)  # no card: host time only
    names = {e.get("name") for e in json.load(open(tmp_path / "trace.json"))["traceEvents"]}
    assert set(PHASES + ["train_step"]) <= names
    summary = json.load(open(tmp_path / "spans.json"))["spans"]
    assert summary["train_step"]["count"] == 1 and summary["train_step"]["host_s"] > 0
    assert telemetry.recorded().keys() == summary.keys()


def test_loader_records_wait_and_assemble_and_counts_starved_calls():
    data = _Records()
    loader = DataLoader(data, batch_size=4, num_workers=2, device="cpu")
    try:
        with _profiler():
            threading.Timer(0.2, data.gate.set).start()
            first = next(loader)  # nothing is queued yet: starved
            deadline = time.time() + 10
            while loader._item_q.qsize() < 4 and time.time() < deadline:
                time.sleep(0.01)
            next(loader)  # a whole batch is queued
    finally:
        loader.close()
    assert first.shape == (1, 4, 16, 16, 3) and first.dtype == torch.uint8
    rec = telemetry.recorded()
    assert {k: v["count"] for k, v in rec.items()} == {"data": 2, "data.wait": 2, "data.assemble": 2}
    assert rec["data"]["counters"] == {"data.starved": 1}
    assert rec["data.wait"]["host_s"] >= 0.1  # the first call waited for the gate
    spans = telemetry.profiling._rec.records
    assert [(s.name, s.parent, s.request) for s in spans] == [
        ("data.wait", "data", 0), ("data.assemble", "data", 0), ("data", None, 0),
        ("data.wait", "data", 1), ("data.assemble", "data", 1), ("data", None, 1)]


def test_render_records_prepare_stage_batches_fetches_and_finish(monkeypatch, tmp_path):
    with _profiler():
        _render(monkeypatch, tmp_path, n_frames=5, batch_size=2)  # 3 batches, the last one padded
    spans = telemetry.profiling._rec.records
    top = spans[-1]
    assert top.name == "render" and top.parent is None
    call = top.request
    assert [(s.name, s.request) for s in spans[:-1]] == [
        ("render.prepare", call), ("render.stage", call),
        ("render.batch", (call, 0)), ("render.fetch", (call, 0)),
        ("render.batch", (call, 1)), ("render.fetch", (call, 1)),
        ("render.batch", (call, 2)), ("render.fetch", (call, 2)),
        ("render.finish", call)]
    assert all(s.parent == "render" for s in spans[:-1])
    children = spans[:-1]
    for a, b in zip(children, children[1:]):
        assert a.end_ns <= b.start_ns and top.start_ns <= a.start_ns and b.end_ns <= top.end_ns
    covered = sum(s.end_ns - s.start_ns for s in children)
    assert covered >= 0.9 * (top.end_ns - top.start_ns)


def test_counters_nest_and_count_flagged_syncs():
    shown = warnings.showwarning
    with _profiler():
        with telemetry.phase("outer", request=7):
            telemetry.count("things", 2)
            with telemetry.phase("inner"):
                telemetry.count("things")
                for _ in range(2):  # as torch words a call that set_sync_debug_mode flags
                    warnings.warn("called a synchronizing CUDA operation (Triggered internally at x.cpp:1.)")
        telemetry.count("things")  # no open span: nothing to count under
        with pytest.raises(ValueError, match="portbench"):
            telemetry.phase("portbench.window")
    rec = telemetry.recorded()
    assert rec["inner"]["counters"] == {"things": 1, "cuda.syncs": 2}
    assert rec["outer"]["counters"] == {"things": 3, "cuda.syncs": 2}
    assert warnings.showwarning is shown  # the watch is taken down with the last span
    assert telemetry.profiling._rec.watch is None and telemetry.profiling._rec.open_threads == 0


@pytest.mark.cuda
def test_device_events_time_the_phases_and_item_counts_one_sync():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device events and sync counting")
    dev = torch.device("cuda")
    cfg, state, step_fn, real, draws = _train(dev)
    step_fn(state, real, draws)  # warm up: builds the kernels
    draws = draw_step(cfg, state.step, torch.Generator(device=dev).manual_seed(1), dev)  # step 1: no regularizer
    x = torch.ones(8, device=dev)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        step_fn(state, real, draws)
        with telemetry.phase("probe", device=dev):
            x.sum().item()
        with telemetry.phase("event_wait"):
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()
    rec = telemetry.recorded()
    assert rec["probe"]["counters"].get("cuda.syncs") == 1
    assert rec["probe"]["device_ms"] > 0
    assert rec["event_wait"]["counters"].get("cuda.syncs", 0) == 0
    total = rec["train_step"]["device_ms"]
    phases = [rec[n]["device_ms"] for n in ("train_step.d", "train_step.ada", "train_step.g", "train_step.tail")]
    assert all(p > 0 for p in phases)
    assert 0.5 * total <= sum(phases) <= total * 1.001
    assert torch.cuda.get_sync_debug_mode() == 0  # restored once no span is open

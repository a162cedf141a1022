"""maua_tpu_torch.telemetry against maua_tpu.telemetry on the CPU: spectral
norms of the StyleGAN2 G and D (the same weights, the same u-vectors: sigma
and the new u within 1e-5 relative, the same flax names), the device monitor's
jsonl, a torch.profiler trace, the memory helpers without a card, and the
train CLI at 16^2 with --log_spec_norm --monitor --profile."""

from __future__ import annotations

import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from maua_tpu.telemetry.spectral import init_spectral_state as jax_init_spectral_state
from maua_tpu.telemetry.spectral import spectral_norms as jax_spectral_norms
from maua_tpu.telemetry.spectral import summarize as jax_summarize
from maua_tpu_torch import telemetry
from maua_tpu_torch.data.synthetic import write_synth_shards
from maua_tpu_torch.telemetry.monitor import DeviceMonitor
from maua_tpu_torch.telemetry.spectral import summarize
from maua_tpu_torch.train.cli import main
from test_torch_port_train import JaxSide, port_state


@pytest.mark.parametrize("net", ["G", "D"])
def test_spectral_norms_match_jax(net):
    """Two power-iteration steps from JAX's u-vectors (n_iter 1, twice):
    every sigma and u, and the min / mean / max summary."""
    _, st = port_state()
    jstate = JaxSide(st).state
    jparams = jstate.g_params if net == "G" else jstate.d_params
    module = st.g if net == "G" else st.d
    ju = jax_init_spectral_state(jparams, jax.random.PRNGKey(3))
    tu = telemetry.init_spectral_state(module)
    assert sorted(tu) == sorted(ju)
    tu = {k: torch.from_numpy(np.array(v)) for k, v in ju.items()}
    for _ in range(2):
        jsig, ju = jax_spectral_norms(jparams, ju)
        tsig, tu = telemetry.spectral_norms(module, tu)
        assert sorted(tsig) == sorted(jsig)
        for k in jsig:
            assert float(tsig[k]) == pytest.approx(float(jsig[k]), rel=1e-5), k
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=0, atol=1e-5)
    want = jax_summarize(jsig)
    for k, v in summarize(tsig).items():
        assert v == pytest.approx(want[k], rel=1e-5), k


def test_device_monitor_writes_windowed_means(tmp_path):
    path = str(tmp_path / "mon" / "gpumon.jsonl")
    mon = DeviceMonitor(path, interval_s=0.01, window=3).start()
    deadline = time.time() + 10
    while time.time() < deadline and not (os.path.exists(path) and open(path).read().count("\n") >= 2):
        time.sleep(0.02)
    mon.stop()
    assert not mon._thread.is_alive()
    lines = [json.loads(x) for x in open(path)]
    assert len(lines) >= 2 and all(x["host_rss_kb"] > 0 and "ts" in x for x in lines)
    assert all(not k.startswith("dev") for x in lines for k in x)  # no card here


def test_profile_trace_and_memory_helpers_on_the_cpu(tmp_path):
    with telemetry.profile_trace(str(tmp_path / "trace")):
        with telemetry.phase("matmul_phase"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    trace = json.load(open(tmp_path / "trace" / "trace.json"))
    assert any(e.get("name") == "matmul_phase" for e in trace["traceEvents"])
    assert "aten::mm" in (tmp_path / "trace" / "key_averages.txt").read_text()
    assert telemetry.memory_snapshot("cpu") == {}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            telemetry.save_device_memory_profile(str(tmp_path / "mem.pickle"))


def test_train_cli_with_telemetry_flags(tmp_path):
    """16^2, 3 steps, --log_spec_norm --monitor --profile --profile_iters 1:
    the sigma summaries of G and D on every log line, the monitor's file, and
    a trace of the first steps with the data and train-step phases."""
    write_synth_shards(str(tmp_path / "s"), 16, 8, fmt="raw", seed=2)
    run = str(tmp_path / "run")
    assert main(["--path", str(tmp_path / "s"), "--size", "16", "--batch_size", "4", "--channel_max", "8",
                 "--device", "cpu", "--run_dir", run, "--iter", "3", "--log_every", "1", "--img_every", "0",
                 "--num_workers", "1", "--log_spec_norm", "--monitor", "--profile", "--profile_iters", "1"]) == 0
    lines = [json.loads(x) for x in open(os.path.join(run, "metrics.jsonl"))]
    assert [x["step"] for x in lines] == [0, 1, 2]
    for x in lines:
        for net in ("G", "D"):
            assert 0 < x[f"{net} spectral_min"] <= x[f"{net} spectral_mean"] <= x[f"{net} spectral_max"]
    assert os.path.exists(os.path.join(run, "gpumon.jsonl"))
    names = {e.get("name") for e in json.load(open(os.path.join(run, "trace", "trace.json")))["traceEvents"]}
    assert {"data", "train_step"} <= names

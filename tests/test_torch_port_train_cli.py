"""The port's train CLI on the CPU at 16^2 (the shards of
test_torch_port_data.py): two steps with the JAX names and a resume, what
still refuses, ADA with adaptive p, and bCR + contrastive + MoCo with a
resume that carries their state. A file of its own beside
test_torch_port_data.py, so that the two run on two workers."""

import json
import os

import numpy as np
import pytest
import torch

from maua_tpu_torch.train.cli import build_parser, main, train_loop
from test_torch_port_data import shards  # noqa: F401  (the fixture)


def _cli_args(shards, run_dir, *extra):
    return ["--path", shards, "--size", "16", "--batch_size", "4", "--channel_max", "32", "--device", "cpu",
            "--run_dir", run_dir, "--num_workers", "2", "--log_every", "1", "--img_every", "0", *extra]


def test_cli_trains_two_steps_and_resumes(shards, tmp_path):
    """`--no-augment`: two steps write two metrics lines with the JAX names and
    a checkpoint; --resume goes on from it to step 3."""
    run = str(tmp_path / "run")
    assert main(_cli_args(shards, run, "--no-augment", "--iter", "2", "--d_reg_every", "1", "--g_reg_every", "1")) == 0
    lines = [json.loads(x) for x in open(os.path.join(run, "metrics.jsonl"))]
    assert [x["step"] for x in lines] == [0, 1]
    for x in lines:
        for k in ("Generator", "Discriminator", "Real Score", "Fake Score", "R1 Penalty",
                  "Path Length Regularization", "Rt", "Augment", "Mean Path Length", "sec_per_iter"):
            assert np.isfinite(x[k]), k
        assert x["R1 Penalty"] > 0 and x["Path Length Regularization"] > 0
        kernels = ("fused_bias_act launches", "fused_bias_act_grad launches", "upfirdn2d launches")
        assert [x[k] for k in kernels] == [0, 0, 0]  # the CPU runs the plain forms
    assert os.listdir(run).count("step_0000002.pt") == 1
    state = train_loop(build_parser().parse_args(_cli_args(shards, run, "--no-augment", "--iter", "3", "--resume")))
    assert state.step == 3
    assert [json.loads(x)["step"] for x in open(os.path.join(run, "metrics.jsonl"))] == [0, 1, 2]


def test_cli_refuses_unported_work(shards, tmp_path):
    """Every flag of the JAX CLI runs now: ADA, bCR and contrastive (below),
    --eval_every (tests/test_torch_port_eval.py), the telemetry flags
    (tests/test_torch_port_telemetry.py), --wandb without wandb
    (tests/test_torch_port_train.py) and the data-parallel flags
    (tests/test_torch_port_parallel.py). What still refuses: a process id
    outside the world, before any rendezvous and before anything is written."""
    run = str(tmp_path / "run")
    with pytest.raises(ValueError, match="outside"):
        main(_cli_args(shards, run, "--iter", "1", "--coordinator", "127.0.0.1:1", "--num_processes", "2",
                       "--process_id", "2"))
    assert not os.path.exists(os.path.join(run, "metrics.jsonl"))


def test_cli_trains_with_ada_bcr_and_contrastive(shards, tmp_path, monkeypatch):
    """The JAX CLI's default (ADA on, adaptive p) for two steps, and bCR +
    contrastive + MoCo (queue 8) for one: finite metrics, ADA's counts
    logged, the resolved warp the CPU's (None, i.e. conv), and a resume
    that carries p, the counts, the head and the queue. Without --device
    cpu and without a card the CLI raises RuntimeError."""
    run = str(tmp_path / "ada")
    state = train_loop(build_parser().parse_args(_cli_args(shards, run, "--iter", "2")))
    lines = [json.loads(x) for x in open(os.path.join(run, "metrics.jsonl"))]
    assert [x["step"] for x in lines] == [0, 1] and all(x["n_pred"] == 4 for x in lines)
    assert all(np.isfinite(v) for x in lines for v in x.values())
    assert state.ada_n.item() == 8 and state.ada_p.item() == 0.0  # below the 256-prediction threshold

    run = str(tmp_path / "cl")
    flags = ["--balanced_consistency", "1", "--contrastive", "0.1", "--contrastive_momentum", "0.99",
             "--contrastive_queue", "8"]
    state = train_loop(build_parser().parse_args(_cli_args(shards, run, "--iter", "1", *flags)))
    assert int(state.cl_state.queue_filled) == 8 and state.cl_head is not None
    resumed = train_loop(build_parser().parse_args(_cli_args(shards, run, "--iter", "1", "--resume", *flags)))
    assert resumed.step == 1
    torch.testing.assert_close(resumed.cl_state.queue, state.cl_state.queue, rtol=0, atol=0)
    torch.testing.assert_close(resumed.cl_head.w1, state.cl_head.w1, rtol=0, atol=0)
    torch.testing.assert_close(resumed.ada_n, state.ada_n, rtol=0, atol=0)

    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        train_loop(build_parser().parse_args(_cli_args(shards, run, "--print_config", "--ada_fft_taper", "0")))
    cfg = json.loads(buf.getvalue())
    assert cfg["augment"] and cfg["ada_warp_method"] is None and cfg["ada_fft_taper"] is None
    assert not cfg["ada_fast_warp"] and cfg["ada_fft_taper_conditional"]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in _cli_args(shards, str(tmp_path / "nocard"), "--iter", "1") if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(args)

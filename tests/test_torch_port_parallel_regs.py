"""maua_tpu_torch's data-parallel regularizers on the CPU: chunked R1 and path
penalty, the contrastive regularizer with MoCo and its queue, and bCR, in two
gloo processes against one process; the contrastive regularizer on two ranks
against the JAX package's on the global batch; the train CLI's automatic
`reg_chunks` / `remat_synth` under a coordinator against the JAX CLI's; and
the guards that refuse a batch the ranks cannot split.

The chain to the JAX package: the one-process train step is held against the
JAX step phase by phase (tests/test_torch_port_train.py,
tests/test_torch_port_train_step.py, tests/test_torch_port_train_configs.py;
R1 in strided chunks against JAX's unchunked R1), and here the two-process
run is held against the one-process run.

The two-process runs go through the train CLI as in
tests/test_torch_port_parallel.py (`--coordinator` on a free localhost port,
`--device cpu`, one loader worker, 16^2, channel_max 8, 3 steps with R1 and
the path penalty due at step 0): the losses of every step (rel 1e-5), ADA's
state and the path-length mean, and G, D and the EMA copy each judged as one
vector within 1e-5 of its largest weight; with the contrastive regularizer
also the projection head, the key encoder and the queue. Each run has a
limit of 90 s.

Under data parallelism each rank's gradient with respect to its own rows is
the world size times its block of the global gradient: every rank computes
the loss of the global batch, and the gather's backward sums the rows'
gradients over the ranks. The mean of the parameter gradients over the ranks
divides that factor out again, so the contrastive test divides the input
gradients by the world size and averages the head's gradients.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maua_tpu.train import contrastive as jcl
from maua_tpu_torch import parallel
from maua_tpu_torch.io import projection_head_state_dict_from_jax
from maua_tpu_torch.train import check_split, make_train_config
from maua_tpu_torch.train.cli import build_parser, train_loop
from test_torch_port_parallel import close, free_port, read_run, run_all, shards  # noqa: F401  (shards: the fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_LIMIT_S = 90
WORLD = 2


def train_cmd(shards, run_dir, batch, extra):
    return [sys.executable, "-m", "maua_tpu_torch.train.cli", "--path", shards, "--size", "16", "--batch_size",
            str(batch), "--channel_max", "8", "--iter", "3", "--log_every", "1", "--img_every", "0",
            "--num_workers", "1", "--device", "cpu", "--run_dir", run_dir, *extra]


CONTRASTIVE = ["--contrastive", "0.1", "--contrastive_momentum", "0.99", "--contrastive_queue", "16"]


@pytest.mark.parametrize("case,batch,extra", [
    ("reg_chunks", 8, ["--reg_chunks", "2", "--remat_synth", "1"]),
    ("contrastive", 4, CONTRASTIVE),
    ("bcr", 4, ["--balanced_consistency", "1"]),
])
def test_two_processes_match_one(shards, tmp_path, case, batch, extra):
    """`--reg_chunks 2` (with `--remat_synth 1`) at a global batch of 8: two
    R1 chunks of 4 rows (2 per rank) and two path chunks of 2 rows (1 per
    rank); contrastive + MoCo + a queue of 16 and bCR at a global batch of 4."""
    port = free_port()
    dp = [train_cmd(shards, str(tmp_path / f"rank{r}"), batch, extra + [
        "--coordinator", f"127.0.0.1:{port}", "--num_processes", str(WORLD), "--process_id", str(r)])
        for r in range(WORLD)]
    outs = run_all(dp + [train_cmd(shards, str(tmp_path / "single"), batch, extra)])
    assert "distributed: process 1/2 on cpu" in outs[1]
    (dp_logs, dp_ckpt), (logs, ckpt) = read_run(tmp_path / "rank0"), read_run(tmp_path / "single")
    assert len(dp_logs) == len(logs) == 3
    for a, b in zip(dp_logs, logs):
        for k in ("Generator", "Discriminator", "Real Score", "Fake Score", "R1 Penalty",
                  "Path Length Regularization", "Rt", "Augment", "Mean Path Length", "sign_sum", "n_pred"):
            assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-7), (case, a["step"], k)
    assert logs[0]["R1 Penalty"] > 0 and logs[0]["Path Length Regularization"] > 0 and logs[0]["n_pred"] == batch
    nets = ["g", "d", "g_ema"]
    if case == "contrastive":
        nets.append("cl_head")
        dp_ckpt["key_d"], ckpt["key_d"] = dp_ckpt["cl_state"]["key_d"], ckpt["cl_state"]["key_d"]
        nets.append("key_d")
        for k in ("queue", "queue_ptr", "queue_filled"):
            close(dp_ckpt["cl_state"][k], ckpt["cl_state"][k], k)
        assert int(ckpt["cl_state"]["queue_filled"]) == 16  # 3 steps of 2 x 4 keys, capped at the queue's 16
    for net in nets:
        keys = sorted(ckpt[net])
        close(torch.cat([dp_ckpt[net][k].reshape(-1) for k in keys]), torch.cat([ckpt[net][k].reshape(-1) for k in keys]),
              net)
    for k in ("mean_path_length", "ada_p", "ada_signs", "ada_n"):
        close(dp_ckpt[k], ckpt[k], k)


# ---------------------------------------------------------------- the regularizer on two ranks against JAX
CL_WORKER = r'''
import json, sys
import numpy as np, torch
from maua_tpu_torch import parallel
from maua_tpu_torch.train import contrastive as tcl

out, port, rank, world = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
torch.set_num_threads(1)
inp = np.load(f"{out}/inputs.npz")
parallel.maybe_initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
try:
    res = {}
    for case in json.loads(sys.argv[5]):
        head = tcl.ProjectionHead(32, bilinear=True)
        head.load_state_dict(torch.load(f"{out}/head.pt"), strict=True)
        b = inp["xs"].shape[1] // world
        xs = [torch.from_numpy(x[rank * b:(rank + 1) * b]).requires_grad_() for x in inp["xs"]]
        wd, wk = torch.from_numpy(inp["wd"]), torch.from_numpy(inp["wk"])
        hidden = lambda w: (lambda x: (x.reshape(x.shape[0], -1) @ w).reshape(x.shape[0], 2, 4, 4))
        st = None
        if case == "infonce_queue":
            st = tcl.ContrastiveState(None, torch.from_numpy(inp["queue"]), torch.tensor(16), torch.tensor(16))
        loss, new = tcl.contrastive_regularizer_moco(
            hidden(wd), hidden(wk) if case == "infonce_queue" else None, head, st, xs[:2], xs[2:],
            loss_type="nt_xent" if case == "nt_xent" else "infonce", gather=parallel.gather_batch)
        params = list(head.parameters())
        grads = torch.autograd.grad(loss, xs + params, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(xs + params, grads)]
        head_grads = grads[len(xs):]
        parallel.all_reduce_mean_(head_grads)
        res[case] = dict(loss=float(loss), x_grads=[(g / world).numpy().tolist() for g in grads[:len(xs)]],
                         head_grads={n: g.numpy().tolist() for (n, _), g in zip(head.named_parameters(), head_grads)})
        if new is not None:
            res[case].update(queue=new.queue.numpy().tolist(), ptr=int(new.queue_ptr), filled=int(new.queue_filled))
    json.dump(res, open(f"{out}/rank_{rank}.json", "w"))
finally:
    parallel.shutdown_distributed()
'''

CL_CASES = ["infonce", "infonce_queue", "nt_xent"]


def _unit_rows(n, d, seed):
    x = np.random.RandomState(seed).randn(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def cl_inputs():
    """Four global batches of 8 features [8, 3, 4, 4] (fakes, reals and their
    augmented copies), D's hidden layer and the key encoder as linear maps,
    a bilinear head from JAX's init with a perturbed key transform, and a
    queue of 32 with 16 slots filled (the 16 global keys of a step then fill
    it, as the `Q % 2B` guard keeps the cursor on a multiple of 2B)."""
    rng = np.random.RandomState(14)
    head = jcl.init_projection_head(jax.random.PRNGKey(3), 32, bilinear=True)
    head["bw"] = head["bw"] + 0.1 * jnp.asarray(rng.randn(128, 128).astype(np.float32))
    queue = np.zeros((32, 128), np.float32)
    queue[:16] = _unit_rows(16, 128, 15)
    return dict(xs=rng.randn(4, 8, 3, 4, 4).astype(np.float32), wd=rng.randn(48, 32).astype(np.float32) / 7,
                wk=rng.randn(48, 32).astype(np.float32) / 7, queue=queue, head=head)


@pytest.fixture(scope="module")
def cl_ranks(cl_inputs, tmp_path_factory):
    out = tmp_path_factory.mktemp("cl_dp")
    np.savez(out / "inputs.npz", **{k: v for k, v in cl_inputs.items() if k != "head"})
    torch.save(projection_head_state_dict_from_jax(cl_inputs["head"]), out / "head.pt")
    script = out / "worker.py"
    script.write_text(CL_WORKER)
    port = free_port()
    run_all([[sys.executable, str(script), str(out), str(port), str(r), str(WORLD), json.dumps(CL_CASES)]
             for r in range(WORLD)])
    return [json.load(open(out / f"rank_{r}.json")) for r in range(WORLD)]


def _within(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1e-12), what


@pytest.mark.parametrize("case", CL_CASES)
def test_contrastive_on_two_ranks_matches_jax(cl_inputs, cl_ranks, case):
    """The loss (equal on both ranks), each rank's input gradients (divided
    by the world size, laid end to end), the head's gradients averaged over
    the ranks and the new queue, cursor and fill against the JAX package's
    contrastive_regularizer_moco on the global batch of 8: InfoNCE, InfoNCE
    with the momentum key encoder and a half-filled queue, NT-Xent."""
    inp = cl_inputs
    hid = lambda w: (lambda x: (x.reshape(x.shape[0], -1) @ w).reshape(x.shape[0], 2, 4, 4))  # noqa: E731
    st = None
    if case == "infonce_queue":
        st = jcl.ContrastiveState(None, jnp.asarray(inp["queue"]), jnp.asarray(16, jnp.int32),
                                  jnp.asarray(16, jnp.int32))

    def loss_fn(xs, head):
        return jcl.contrastive_regularizer_moco(hid(inp["wd"]), hid(inp["wk"]) if case == "infonce_queue" else None,
                                                head, st, [xs[0], xs[1]], [xs[2], xs[3]],
                                                loss_type="nt_xent" if case == "nt_xent" else "infonce")

    (want, new), (x_grads, head_grads) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(inp["xs"]), inp["head"])
    ranks = [r[case] for r in cl_ranks]
    for r in ranks:
        _within(r["loss"], want, "loss")
    _within(np.concatenate([np.stack(r["x_grads"]) for r in ranks], axis=1), x_grads, "input gradients")
    for name, g in head_grads.items():
        for r in ranks:
            _within(r["head_grads"][name], g, f"head gradient {name}")
    if case == "infonce_queue":
        for r in ranks:
            _within(r["queue"], new.queue, "queue")
            assert r["ptr"] == int(new.queue_ptr) == 0 and r["filled"] == int(new.queue_filled) == 32
    else:
        assert "queue" not in ranks[0]


# ---------------------------------------------------------------- the CLI's automatic rule and the guards
def _config(argv, jax_cli=False):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if jax_cli:
            from maua_tpu.train.cli import main as jax_main

            assert jax_main(argv) == 0
        else:
            train_loop(build_parser().parse_args(argv))
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("size,batch", [(512, 12), (1024, None), (256, 12)])
@pytest.mark.parametrize("coordinator", [False, True])
def test_cli_resolves_reg_chunks_and_remat_as_jax(size, batch, coordinator):
    """`reg_chunks` batch // 4 and `remat_synth` on from 512^2 (1 and off
    below), with or without a world-1 gloo coordinator, as the JAX CLI's
    --print_config resolves them; the process group is closed after."""
    argv = ["--path", "/nonexistent", "--size", str(size), "--print_config"]
    argv += [] if batch is None else ["--batch_size", str(batch)]
    want = _config(argv, jax_cli=True)
    extra = ["--coordinator", f"127.0.0.1:{free_port()}", "--num_processes", "1", "--process_id", "0"] if coordinator else []
    got = _config(argv + ["--device", "cpu"] + extra)
    assert not torch.distributed.is_initialized()
    big = size >= 512
    assert (got["reg_chunks"], got["remat_synth"]) == (want["reg_chunks"], want["remat_synth"]) == \
        ((12 // 4, True) if big else (1, False))
    assert {k: v for k, v in got.items() if k != "ada_warp_method"} == {k: v for k, v in want.items()
                                                                        if k != "ada_warp_method"}


@pytest.mark.parametrize("batch,world,k,match", [
    (12, 4, 3, r"path penalty's chunk of 2 rows .* over 4 ranks: no reg_chunks splits a global batch of 12 over 4 "
               r"ranks; a global batch of 16 splits with reg_chunks \(--reg_chunks\) 1 or 2"),
    (16, 4, 4, r"chunk of 2 rows \(global batch 16 // path_batch_shrink 2 // reg_chunks 4\) does not split over 4 "
               r"ranks: reg_chunks \(--reg_chunks\) 1 or 2 would split it"),
    (24, 4, 4, r"the local batch 6 \(global batch 24 over 4 ranks\) does not split into reg_chunks 4 R1 chunks"),
    (6, 4, 1, r"the global batch 6 does not split over 4 ranks"),
])
def test_split_guard_names_its_numbers(batch, world, k, match):
    """check_split names the global batch, the world size, k and a
    reg_chunks that splits (or the next global batch that does); a batch
    that splits passes, and one process never refuses."""
    cfg = make_train_config(batch_size=batch, reg_chunks=k)
    with pytest.raises(ValueError, match=match):
        check_split(cfg, world)
    check_split(cfg, 1)
    check_split(make_train_config(batch_size=12, reg_chunks=3), 2)


def test_cli_guard_raises_before_the_first_step(shards, tmp_path):
    """Two gloo processes at a global batch of 4 with `--reg_chunks 2`: the
    local batch of 2 splits into 2 chunks, but the path penalty's chunk of
    1 row does not split over the 2 ranks. Both ranks raise ValueError
    before the first step (when the CLI builds the step), and no metrics are
    written."""
    port = free_port()
    cmds = [train_cmd(shards, str(tmp_path / f"rank{r}"), 4, ["--reg_chunks", "2", "--no-augment", "--coordinator",
                                                              f"127.0.0.1:{port}", "--num_processes", str(WORLD),
                                                              "--process_id", str(r)]) for r in range(WORLD)]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    try:
        errs = [p.communicate(timeout=RUN_LIMIT_S)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, err in zip(procs, errs):
        assert p.returncode != 0
        assert "ValueError: the path penalty's chunk of 1 rows" in err and "over 2 ranks" in err, err[-2000:]
    assert not any(os.path.exists(tmp_path / f"rank{r}" / "metrics.jsonl") for r in range(WORLD))

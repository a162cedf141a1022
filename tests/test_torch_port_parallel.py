"""maua_tpu_torch.parallel against maua_tpu.parallel on the CPU: padding,
the loader's split of the global batch over ranks, data-parallel training in
two gloo processes against one process, and frame-parallel render() and
generate() over a mesh of two CPU devices against no mesh.

The two-process runs go through the train CLI (`--coordinator` on a free
localhost port, `--num_processes 2`, `--device cpu`, one loader worker so
the record order is fixed) at 16^2 with channel_max 8 and a global batch of
4, against the same CLI without a coordinator. Step 0 runs R1 and the path
penalty, so the cross-rank minibatch stddev is differentiated twice. The
losses of every step (rel 1e-5), the path-length mean and ADA's state agree,
and so do the final weights of G, D and the EMA copy, each network judged as
one vector: within 1e-5 of its largest weight. (Judged tensor by tensor, a
mapping-layer bias of G misses by 2e-4 of its own largest value: its
gradient is a nearly cancelling sum, which the ranks add in another order
than one process does, and Adam's first steps scale each element to about
lr whatever its size.) Each run has a limit of 90 s."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maua_tpu.data as jdata
import maua_tpu.parallel as jpar
from maua_tpu_torch import parallel
from maua_tpu_torch.data import DataLoader, MultiResolutionRecordDataset
from maua_tpu_torch.data import loader as loader_mod
from maua_tpu_torch.data.synthetic import write_synth_shards

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_LIMIT_S = 90


@pytest.mark.parametrize("n,multiple,axis", [(5, 4, 0), (8, 4, 0), (3, 2, 1), (1, 8, 0)])
def test_pad_to_multiple_matches_jax(n, multiple, axis):
    x = np.random.default_rng(n).standard_normal((n, 3) if axis == 0 else (2, n)).astype(np.float32)
    got, got_n = parallel.pad_to_multiple(torch.from_numpy(x), multiple, axis)
    want, want_n = jpar.pad_to_multiple(jnp.asarray(x), multiple, axis)
    assert got_n == want_n == n
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_helpers_without_a_process_group():
    x = torch.arange(6.0)
    assert parallel.process_count() == 1 and parallel.process_index() == 0 and parallel.is_main_process()
    assert parallel.shard_batch(x) is x and parallel.gather_batch(x) is x and parallel.local_rows(x) is x
    assert parallel.all_reduce_sum(x) is x
    tree = {"a": torch.tensor(1.0)}
    assert parallel.all_reduce_mean_tree(tree) is tree
    assert not parallel.maybe_initialize_distributed(None, device="cpu")
    assert parallel.get_mesh(["cpu", "cpu"]) == [torch.device("cpu")] * 2


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dp_shards"))
    write_synth_shards(out, 16, 20, fmt="raw", seed=5)
    return out


@pytest.mark.parametrize("accumulate", [1, 2])
def test_loader_rank_blocks_make_the_jax_global_batch(shards, monkeypatch, accumulate):
    """Two ranks' batches (uint8, flips included), laid end to end, are the
    batches the JAX loader gives one process from the same seed, over more
    than one epoch."""
    jds = jdata.MultiResolutionRecordDataset(shards, resolution=16, uint8_hwc=True)
    jl = jdata.DataLoader(jds, batch_size=4, num_accumulate=accumulate, num_workers=1, seed=3)
    try:
        want = [np.asarray(next(jl)) for _ in range(6)]
    finally:
        jl.close()
    got = []
    for rank in range(2):
        monkeypatch.setattr(loader_mod, "process_count", lambda: 2)
        monkeypatch.setattr(loader_mod, "process_index", lambda r=rank: r)
        tl = DataLoader(MultiResolutionRecordDataset(shards, resolution=16, uint8_hwc=True), batch_size=4,
                        num_accumulate=accumulate, num_workers=1, seed=3, device="cpu")
        try:
            got.append([next(tl).numpy() for _ in range(6)])
        finally:
            tl.close()
    for t in range(6):
        assert got[0][t].shape == (accumulate, 2, 16, 16, 3)
        np.testing.assert_array_equal(np.concatenate([got[0][t], got[1][t]], axis=1), want[t])


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def train_cmd(shards, run_dir, extra):
    return [sys.executable, "-m", "maua_tpu_torch.train.cli", "--path", shards, "--size", "16", "--batch_size", "4",
            "--channel_max", "8", "--iter", "3", "--log_every", "1", "--img_every", "0", "--num_workers", "1",
            "--device", "cpu", "--run_dir", run_dir, *extra]


def run_all(cmds):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=RUN_LIMIT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def read_run(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    ckpt = torch.load(os.path.join(run_dir, "step_0000003.pt"), map_location="cpu", weights_only=False)
    return logs, ckpt


def close(got, want, what):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    scale = max(float(want.abs().max()), 1e-12)
    assert float((got - want).abs().max()) <= 1e-5 * scale, what


@pytest.mark.parametrize("case,extra", [
    ("no_ada", ["--no-augment"]),
    ("adaptive_p", []),
    ("fixed_p", ["--augment_p", "0.5"]),
])
def test_two_processes_match_one(shards, tmp_path, case, extra):
    port = free_port()
    dp = [train_cmd(shards, str(tmp_path / f"rank{r}"), extra + [
        "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2", "--process_id", str(r)]) for r in range(2)]
    outs = run_all(dp + [train_cmd(shards, str(tmp_path / "single"), extra)])
    assert "distributed: process 0/2 on cpu" in outs[0] and "distributed: process 1/2 on cpu" in outs[1]
    assert not os.path.exists(tmp_path / "rank1" / "metrics.jsonl")  # rank 0 alone writes
    (dp_logs, dp_ckpt), (logs, ckpt) = read_run(tmp_path / "rank0"), read_run(tmp_path / "single")
    assert len(dp_logs) == len(logs) == 3
    for a, b in zip(dp_logs, logs):
        for k in ("Generator", "Discriminator", "Real Score", "Fake Score", "R1 Penalty",
                  "Path Length Regularization", "Rt", "Augment", "Mean Path Length", "sign_sum", "n_pred"):
            assert a[k] == pytest.approx(b[k], rel=1e-5, abs=1e-7), (a["step"], k)
    assert logs[0]["R1 Penalty"] > 0 and logs[0]["Path Length Regularization"] > 0
    for net in ("g", "d", "g_ema"):
        keys = sorted(ckpt[net])
        close(torch.cat([dp_ckpt[net][k].reshape(-1) for k in keys]), torch.cat([ckpt[net][k].reshape(-1) for k in keys]),
              net)
    for k in ("mean_path_length", "ada_p", "ada_signs", "ada_n"):
        close(dp_ckpt[k], ckpt[k], k)


def _sink(frames):
    class Sink:
        def __init__(self, output_file, width, height, fps, **kw):
            pass

        def write(self, frame):
            frames.append(np.array(frame))

        def close(self):
            pass

    return Sink


def small_generator(seed=0):
    from maua_tpu_torch.models import Generator

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        gen = Generator(size=32, style_dim=64, n_mlp=2, channel_max=16, constant_input=True)
        with torch.no_grad():
            for name, p in gen.named_parameters():
                if name.endswith("bias") or "noise" in name:
                    p.normal_(0.0, 0.2)
    return gen.eval()


def test_render_mesh_matches_no_mesh(tmp_path, monkeypatch):
    """7 frames at batch 3 over a mesh of two CPU devices (each batch padded
    to 4 and split in two), with tensor truncation, explicit noise, a bend
    with a per-frame modulation and a rewrite: the same uint8 frames as
    without a mesh, within one level (the CPU convs of a 2-frame part and of
    a 3-frame batch round differently, which moves a few values across a
    rounding boundary)."""
    import maua_tpu_torch.render.frames as frames_mod
    from maua_tpu_torch.reactive import Bend, Rewrite

    gen = small_generator()
    n, rng = 7, np.random.default_rng(2)
    latents = rng.standard_normal((n, gen.n_latent, 64)).astype(np.float32)
    noise = [None if i % 2 else rng.standard_normal((n, 1, 2 ** (2 + (i + 1) // 2), 2 ** (2 + (i + 1) // 2)))
             .astype(np.float32) for i in range(gen.num_layers)]
    mod = np.linspace(0.0, 1.0, n).astype(np.float32)
    common = dict(latents=latents, noise=noise, batch_size=3, fps=4, truncation=np.linspace(0.6, 1.0, n),
                  truncation_latent=rng.standard_normal((1, 64)).astype(np.float32), device="cpu",
                  bends=[Bend(2, lambda x, m: x * (1 + m[:, None, None, None]), mod)],
                  rewrites=[Rewrite("convs.1.conv.weight", lambda w, m: w * (1 + 0.5 * m.mean()), mod)])
    out = {}
    for label, mesh in (("mesh", parallel.get_mesh(["cpu", "cpu"])), ("plain", None)):
        out[label] = []
        monkeypatch.setattr(frames_mod, "VideoWriter", _sink(out[label]))
        frames_mod.render(gen, None, output_file=str(tmp_path / f"{label}.mp4"), mesh=mesh, **common)
    assert len(out["mesh"]) == len(out["plain"]) == n
    assert np.abs(np.stack(out["mesh"]).astype(np.int16) - np.stack(out["plain"])).max() <= 1
    assert np.stack(out["plain"]).std() > 0


def test_generate_mesh_matches_no_mesh(tmp_path, monkeypatch):
    """generate() of 1.5 s at 4 fps, batch 3, with the default plugin, over a
    mesh of two CPU devices and without one: the same frames within one
    level, as above."""
    import scipy.io.wavfile

    import maua_tpu_torch.audio as tar
    import maua_tpu_torch.render.frames as frames_mod
    from maua_tpu_torch.pipeline import generate

    monkeypatch.chdir(tmp_path)
    ckpt = str(tmp_path / "g.pt")
    torch.save({"g_ema": small_generator().state_dict()}, ckpt)
    sr = 22050
    t = np.arange(int(2.0 * sr)) / sr
    y = 0.2 * np.sin(2 * np.pi * 220 * t) * (1 + np.sign(np.sin(2 * np.pi * 2 * t)))
    scipy.io.wavfile.write(str(tmp_path / "a.wav"), sr, (y * 32767).astype(np.int16))
    smf = tar.get_SMF()
    out = {}
    try:
        for label, mesh in (("mesh", ["cpu", "cpu"]), ("plain", None)):
            out[label] = []
            monkeypatch.setattr(frames_mod, "VideoWriter", _sink(out[label]))
            generate(ckpt, str(tmp_path / "a.wav"), G_res=32, out_size=32, fps=4, duration=1.5, batch=3,
                     latent_dim=64, n_mlp=2, output_file=str(tmp_path / f"{label}.mp4"), mesh=mesh, device="cpu")
    finally:
        tar.set_SMF(smf)
        tar.set_device(None)
    assert len(out["mesh"]) == len(out["plain"]) == 6
    assert np.abs(np.stack(out["mesh"]).astype(np.int16) - np.stack(out["plain"])).max() <= 1

"""maua_tpu_torch's eval CLI and the train CLI's periodic eval on the CPU: the
inception subcommand's statistics against the JAX CLI's from the same
weights file, fid and ppl (with and without LPIPS weights) with the JAX
CLI's JSON fields, the refusal to run without a card unless asked for the
CPU, and --eval_every with SWD (the logged value against the JAX package's
swd of the same images) and with FID. Inception statistics within 1e-4 of
their largest value (94 fp32 convs in two libraries)."""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_eval import close, inception_sd

import maua_tpu.eval.cli as jcli
import maua_tpu.eval.swd as jswd
import maua_tpu_torch.eval.cli as tcli
from maua_tpu.models import Generator as JaxGenerator
from maua_tpu_torch.data.synthetic import write_synth_shards
from maua_tpu_torch.io import generator_state_dict_from_jax
from maua_tpu_torch.train.cli import build_parser, train_loop
from maua_tpu_torch.train.cli import main as train_main

FID_FIELDS = {"fid", "calibrated_features", "pretrained", "weights_fingerprint", "feature_net", "truncation"}
PPL_FIELDS = {"ppl", "distance", "pretrained", "weights_fingerprint"}
INCEPTION_FIELDS = {"n_features", "calibrated", "pretrained", "weights_fingerprint", "out"}


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    p = tmp_path_factory.mktemp("w") / "inception_v3.pth"
    torch.save({k: torch.from_numpy(v) for k, v in inception_sd().items()}, str(p))
    return str(p)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A 32^2 generator (channel_max 32) with JAX's initial weights, carried across."""
    gen = JaxGenerator(size=32, constant_input=True, channel_max=32)
    v = gen.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, jnp.zeros((1, 512)))
    p = tmp_path_factory.mktemp("ckpt") / "g32.pt"
    torch.save({"g_ema": generator_state_dict_from_jax(v["params"], v["buffers"])}, str(p))
    return str(p)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    write_synth_shards(str(root), 16, 12, seed=0, shard_size=8)
    return str(root)


def last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_eval_cli_subcommands(weights, ckpt, shards, tmp_path, capsys):
    """inception (stats equal to the JAX CLI's from the same weights file,
    and the same JSON fields), fid on those stats and ppl with and without
    LPIPS weights: the JAX CLI's fields, finite values, --device cpu."""
    wpath = weights
    stats_t, stats_j = str(tmp_path / "t.pkl"), str(tmp_path / "j.pkl")
    assert tcli.main(["inception", "--path", shards, "--size", "16", "--batch", "4", "--n_sample", "4",
                      "--out", stats_t, "--inception_weights", wpath, "--device", "cpu"]) == 0
    out_t = last_json(capsys)
    assert jcli.main(["inception", "--path", shards, "--size", "16", "--batch", "4", "--n_sample", "4",
                      "--out", stats_j, "--inception_weights", wpath]) == 0
    out_j = last_json(capsys)
    assert set(out_t) == set(out_j) == INCEPTION_FIELDS
    assert out_t["n_features"] == out_j["n_features"] == 2048 and out_t["pretrained"] is out_j["pretrained"] is True
    with open(stats_t, "rb") as f:
        mu_t, sigma_t = pickle.load(f)
    with open(stats_j, "rb") as f:
        mu_j, sigma_j = pickle.load(f)
    scale = float(np.abs(mu_j).max())
    close(mu_t / scale, mu_j / scale, 1e-4)
    close(sigma_t / scale**2, sigma_j / scale**2, 1e-4)

    assert tcli.main(["fid", "--ckpt", ckpt, "--stats", stats_t, "--n_sample", "2", "--batch", "2",
                      "--inception_weights", wpath, "--device", "cpu"]) == 0
    out = last_json(capsys)
    assert set(out) == FID_FIELDS and np.isfinite(out["fid"])
    assert out["feature_net"] == "torchvision-inception" and out["truncation"] == "U(0.9,1.5)"
    assert out["weights_fingerprint"] == out_t["weights_fingerprint"]

    assert tcli.main(["ppl", "--ckpt", ckpt, "--n_sample", "2", "--batch", "2", "--device", "cpu"]) == 0
    out = last_json(capsys)
    assert set(out) == PPL_FIELDS and out["distance"] == "multiscale-l2-proxy" and out["weights_fingerprint"] is None
    assert np.isfinite(out["ppl"]) and out["ppl"] > 0

    from test_torch_port_inference import torchvision_features

    lp = str(tmp_path / "vgg16.pth")
    torch.save({k: torch.from_numpy(v) for k, v in torchvision_features("vgg").items()}, lp)
    assert tcli.main(["ppl", "--ckpt", ckpt, "--n_sample", "2", "--batch", "2", "--lpips_weights", lp,
                      "--device", "cpu"]) == 0
    out = last_json(capsys)
    assert out["distance"] == "lpips-vgg" and out["pretrained"] is True and len(out["weights_fingerprint"]) == 16
    assert np.isfinite(out["ppl"])


def test_eval_cli_ppl_refuses_fast(ckpt, capsys):
    """ppl runs exact only: under --precision fast it raises before loading
    anything, and its --help says so."""
    with pytest.raises(ValueError, match="exact only"):
        tcli.main(["ppl", "--ckpt", ckpt, "--n_sample", "2", "--batch", "2", "--device", "cpu", "--precision", "fast"])
    with pytest.raises(SystemExit):
        tcli.main(["ppl", "--help"])
    assert "exact only" in capsys.readouterr().out


def test_eval_cli_without_a_card_needs_cpu(ckpt):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["ppl", "--ckpt", ckpt, "--n_sample", "2", "--batch", "2"])


def _train_args(shards, run, *extra):
    return ["--path", shards, "--size", "16", "--batch_size", "4", "--channel_max", "32", "--device", "cpu",
            "--run_dir", run, "--num_workers", "1", "--log_every", "1", "--img_every", "0", "--no-augment", *extra]


def test_train_cli_eval_swd(shards, tmp_path, capsys):
    """--eval_every 1 --eval_metric swd for two steps: the SWD line of step
    1 in metrics.jsonl equals the JAX package's swd of the same reals and
    of the final EMA generator's samples (Draws(seed + 7 + step), truncation
    1 toward the mean of 2^14 mapped z from Draws(seed))."""
    from maua_tpu_torch.data import MultiResolutionRecordDataset
    from maua_tpu_torch.draws import Draws
    from maua_tpu_torch.eval.cli import make_fid_sampler

    run = str(tmp_path / "run")
    state = train_loop(build_parser().parse_args(_train_args(shards, run, "--iter", "2", "--eval_every", "1",
                                                             "--eval_metric", "swd", "--swd_n_sample", "10",
                                                             "--fid_batch", "4")))
    lines = [json.loads(x) for x in open(os.path.join(run, "metrics.jsonl"))]
    evals = [x for x in lines if "SWD" in x]
    assert [x["step"] for x in evals] == [1]
    assert {"swd_16", "swd_avg", "step", "eval_seconds"} <= set(evals[0])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {"SWD": evals[0]["SWD"], "step": 1}

    ds = MultiResolutionRecordDataset(shards, 16, uint8_hwc=True)
    reals = np.stack([ds[i] for i in range(10)]).transpose(0, 3, 1, 2).astype(np.float32) / 127.5 - 1.0
    with torch.no_grad():
        g = state.g_ema
        mean_w = g.get_latent(Draws(0, "cpu").normal(2**14, 512)).mean(dim=0, keepdim=True)
        synth, draws = make_fid_sampler(g, mean_w), Draws(7 + 1, "cpu")
        fakes = np.concatenate([synth(draws, 4, 1.0).numpy() for _ in range(3)])[:10]
    want = jswd.swd(reals, fakes)
    assert evals[0]["SWD"] == pytest.approx(want["swd_avg"], rel=1e-6)


def test_train_cli_eval_fid(weights, shards, tmp_path, capsys):
    """--eval_every 2 --eval_metric fid against the port's own inception
    stats: one FID line at step 2, with the backbone's provenance."""
    wpath = weights
    stats = str(tmp_path / "stats.pkl")
    assert tcli.main(["inception", "--path", shards, "--size", "16", "--batch", "4", "--n_sample", "4",
                      "--out", stats, "--inception_weights", wpath, "--device", "cpu"]) == 0
    fingerprint = last_json(capsys)["weights_fingerprint"]
    run = str(tmp_path / "run")
    assert train_main(_train_args(shards, run, "--iter", "3", "--eval_every", "2", "--inception_stats", stats,
                                  "--inception_weights", wpath, "--fid_n_sample", "2", "--fid_batch", "2")) == 0
    evals = [json.loads(x) for x in open(os.path.join(run, "metrics.jsonl")) if "FID" in json.loads(x)]
    assert [x["step"] for x in evals] == [2]
    assert np.isfinite(evals[0]["FID"]) and evals[0]["FID"] == evals[0]["fid"]
    assert evals[0]["pretrained"] is True and evals[0]["weights_fingerprint"] == fingerprint

"""The port's VAE family (models/autoencoder.py, train/vae.py, train/vae_cli.py,
data/prepare_vae_codes.py) against the JAX package's on the CPU in fp32.

Each model is initialised by flax, and its variables go through
`vae_state_dict_from_jax` into the port's module. The reparameterisation's
normal draw is the one flax makes: `make_rng("latent")` of the top-level
module is the key `LazyRng.create(key, 1)` folds to, which the tests check
before they use it. Tolerances: forwards and running statistics within 1e-5
of the largest value; the losses within 1e-6 relative; three Adam steps of
`train_vae` within 1e-4 of each tensor's largest value (Adam's first step is
lr * sign(g) for most elements, so a gradient that rounds differently in the
two packages moves a weight by up to 2 * lr: see the test)."""

from __future__ import annotations

import itertools
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core.scope import LazyRng

import maua_tpu.models.autoencoder as jae
from maua_tpu.data.prepare_vae_codes import encode_dataset as jax_encode_dataset
from maua_tpu.train.vae import train_vae as jax_train_vae
from maua_tpu_torch.data import RecordShardReader
from maua_tpu_torch.data.prepare_vae_codes import encode_dataset, load_vae, main as codes_main, write_code_shards
from maua_tpu_torch.data.synthetic import write_synth_shards
from maua_tpu_torch.io import vae_state_dict_from_jax
from maua_tpu_torch.models import autoencoder as tae
from maua_tpu_torch.ops import fused_act
from maua_tpu_torch.train import vae_cli
from maua_tpu_torch.train.vae import FAILURE_SCORE, sweep_trial, train_vae

SIZE, BATCH = 32, 4


def close(got, want, rel=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"{what}: {err:.3g} of the largest value > {rel}"


def flax_latent_key(key):
    """The key the top-level module's make_rng("latent") returns."""
    return LazyRng.create(key, 1).as_jax_rng()


MODELS = {
    "logcosh": (lambda: jae.LogCoshVAE(hidden_dims=(4, 8, 16, 32), latent_dim=16),
                lambda: tae.LogCoshVAE(size=SIZE, hidden_dims=(4, 8, 16, 32), latent_dim=16), True),
    "segnet": (lambda: jae.ConvSegNet(width_mult=0.0625), lambda: tae.ConvSegNet(width_mult=0.0625), False),
    "vsegnet": (lambda: jae.VariationalConvSegNet(width_mult=0.0625),
                lambda: tae.VariationalConvSegNet(size=SIZE, width_mult=0.0625), True),
    "inception": (lambda: jae.InceptionVAE(base=8, latent_dim=16, n_down=2),
                  lambda: tae.InceptionVAE(size=SIZE, base=8, latent_dim=16, n_down=2), True),
}


def images(seed, n=BATCH):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3, SIZE, SIZE)).astype(np.float32)


def build_pair(name):
    jmodel_fn, tmodel_fn, variational = MODELS[name]
    jm = jmodel_fn()
    x = images(0)
    variables = jm.init({"params": jax.random.PRNGKey(1), "latent": jax.random.PRNGKey(2)}, jnp.asarray(x))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    tm = tmodel_fn()
    tm.load_state_dict(vae_state_dict_from_jax(variables, tm))
    return jm, tm, variables, variational


def jax_apply(jm, variables, x, key, train, variational):
    kw = {"rng": key} if variational else {}
    out, upd = jm.apply(variables, jnp.asarray(x), train=train, mutable=["batch_stats"], **kw)
    return out, upd


# The SegNets stack 13 batch norms, the deepest over 4 samples of 1x1 maps,
# which amplifies each package's fp32 rounding: at 32^2 the JAX forward lands
# 1.2e-4 of the largest value from a float64 evaluation of the port, the port's
# own fp32 forward 2.5e-5. They are held to JAX at 2e-4, and the port to its
# float64 self at 5e-5.
FORWARD_TOL = {"logcosh": 1e-5, "segnet": 2e-4, "vsegnet": 2e-4, "inception": 1e-5}


@pytest.mark.parametrize("name", list(MODELS))
def test_vae_forward_and_running_stats_match_jax(name):
    """Train mode (batch statistics, running statistics updated) and then eval
    mode on those running statistics: outputs and statistics within 1e-5 of
    the largest value (the SegNets: FORWARD_TOL)."""
    jm, tm, variables, variational = build_pair(name)
    rel = FORWARD_TOL[name]
    x = images(3)
    key = jax.random.PRNGKey(4)
    out, upd = jax_apply(jm, variables, x, key, True, variational)
    eps = None
    if variational:
        mu = out[1]
        eps = torch.from_numpy(np.array(jax.random.normal(key, mu.shape)))
    tm.train()
    got = tm(torch.from_numpy(x), eps=eps) if variational else tm(torch.from_numpy(x))
    outs = out if variational else (out,)
    gots = got if variational else (got,)
    for g, w, what in zip(gots, outs, ("recon", "mu", "log_var")):
        close(g.detach().numpy(), w, rel=rel, what=f"{name} train {what}")
    if rel > 1e-5:
        import copy

        with torch.no_grad():
            m64 = copy.deepcopy(tm).double()
            x64 = torch.from_numpy(x).double()
            ref = m64(x64, eps=eps.double()) if variational else m64(x64)
        close(gots[0].detach().numpy(), (ref[0] if variational else ref).numpy(), rel=5e-5, what=f"{name} vs float64")
    want_sd = vae_state_dict_from_jax({"params": variables["params"], "batch_stats": upd["batch_stats"]}, tm)
    for k, v in tm.state_dict().items():
        if "running" in k:
            close(v.numpy(), want_sd[k].numpy(), rel=rel, what=f"{name} {k}")

    evars = {"params": variables["params"], "batch_stats": jax.tree_util.tree_map(np.asarray, upd["batch_stats"])}
    out, _ = jax_apply(jm, evars, x, key, False, variational)
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x), eps=eps) if variational else tm(torch.from_numpy(x))
    for g, w, what in zip(got if variational else (got,), out if variational else (out,), ("recon", "mu", "log_var")):
        close(g.numpy(), w, rel=rel, what=f"{name} eval {what}")


def test_flax_latent_key_is_make_rng():
    jm, _, variables, _ = build_pair("logcosh")
    x, key = jnp.asarray(images(5)), jax.random.PRNGKey(6)
    a, _ = jm.apply(variables, x, rngs={"latent": key}, mutable=["batch_stats"])
    b, _ = jm.apply(variables, x, rng=flax_latent_key(key), mutable=["batch_stats"])
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))


def test_vae_losses_match_jax():
    rng = np.random.default_rng(7)
    real, fake = (rng.uniform(-1, 1, (BATCH, 3, 8, 8)).astype(np.float32) for _ in range(2))
    mu, log_var = (0.5 * rng.standard_normal((BATCH, 16)).astype(np.float32) for _ in range(2))
    jl = jae.LogCoshVAE(alpha=10.0, beta=0.5, kld_weight=2.0).loss(*map(jnp.asarray, (real, fake, mu, log_var)))
    tl = tae.LogCoshVAE(size=64, alpha=10.0, beta=0.5, kld_weight=2.0).loss(
        *map(torch.from_numpy, (real, fake, mu, log_var)))
    jv = jae.vae_loss(*map(jnp.asarray, (real, fake, mu, log_var)), kld_weight=0.3)
    tv = tae.vae_loss(*map(torch.from_numpy, (real, fake, mu, log_var)), kld_weight=0.3)
    for got, want in ((tl, jl), (tv, jv)):
        assert set(got) == set(want)
        for k in want:
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6, abs=1e-7), k
    with pytest.raises(ValueError, match="2\\*\\*"):
        tae.LogCoshVAE(size=64).loss(torch.zeros(1, 3, 128, 128), torch.zeros(1, 3, 64, 64),
                                     torch.zeros(1, 4), torch.zeros(1, 4))


class Replay:
    """A draws object that serves precomputed normals in order."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def normal(self, *shape):
        a = self.arrays.pop(0)
        assert tuple(a.shape) == shape
        return torch.from_numpy(np.array(a))


def test_train_vae_three_steps_match_jax():
    """Three steps of the JAX trainer (flax BatchNorm: biased variance,
    momentum 0.9) against the port's from the same weights and draws: the
    logged losses, the parameters and the batch statistics."""
    jm = jae.LogCoshVAE(hidden_dims=(4, 8, 16, 32), latent_dim=16)
    batches = [images(10 + i) for i in range(4)]
    rng = jax.random.PRNGKey(0)
    jvars, jhist = jax_train_vae(jm, iter(batches), n_steps=3, lr=1e-3, log_every=1, rng=rng)

    # the JAX trainer's keys: init from split(rng, 3), then one split per step
    rng, k_init, k_lat = jax.random.split(rng, 3)
    init = jm.init({"params": k_init, "latent": k_lat}, jnp.asarray(batches[0]))
    eps = []
    for _ in range(3):
        rng, key = jax.random.split(rng)
        eps.append(np.asarray(jax.random.normal(flax_latent_key(key), (BATCH, 16))))
    tm = tae.LogCoshVAE(size=SIZE, hidden_dims=(4, 8, 16, 32), latent_dim=16)
    tm.load_state_dict(vae_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, dict(init)), tm))
    state, thist = train_vae(tm, iter(map(torch.from_numpy, batches)), n_steps=3, lr=1e-3, log_every=1,
                             draws=Replay(eps))
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] == [0, 1, 2]
    for th, jh in zip(thist, jhist):
        for k in ("Total", "Reconstruction", "Kullback Leibler Divergence"):
            assert th[k] == pytest.approx(jh[k], rel=1e-5), k
    want = vae_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jvars), tm)
    for k, v in state.items():
        close(v.numpy(), want[k].numpy(), rel=1e-4, what=k)


def test_sweep_trial_halves_batch_on_oom():
    """A simulated out-of-memory error above batch 2 halves the batch twice;
    a divergent run scores FAILURE_SCORE; another error propagates."""
    seen = []

    def data_fn(batch):
        seen.append(batch)
        if batch > 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return itertools.repeat(torch.from_numpy(images(0, batch)))

    model_fn = lambda: tae.LogCoshVAE(size=SIZE, hidden_dims=(4, 8, 16, 32), latent_dim=8)  # noqa: E731
    score, state = sweep_trial(model_fn, data_fn, batch_size=8, n_steps=2, log_every=1,
                               draws=Replay(np.zeros((2, 2, 8), np.float32)))
    assert seen == [8, 4, 2]
    assert score != FAILURE_SCORE and np.isfinite(score) and state is not None

    score, state = sweep_trial(model_fn, lambda b: itertools.repeat(torch.from_numpy(images(0, b))), batch_size=2,
                               n_steps=2, log_every=1, lr=1e30, draws=Replay(np.zeros((2, 2, 8), np.float32)))
    assert score == FAILURE_SCORE and state is None

    def broken(batch):
        raise RuntimeError("a bug")

    with pytest.raises(RuntimeError, match="a bug"):
        sweep_trial(model_fn, broken, batch_size=4)

    def too_big(batch):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    assert sweep_trial(model_fn, too_big, batch_size=4, min_batch=2) == (FAILURE_SCORE, None)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("vae_shards"))
    write_synth_shards(out, SIZE, 10, fmt="raw", seed=3)
    return out


def test_vae_cli_trains_and_writes_its_lines(shards, tmp_path, capsys):
    """--size 32 with 4 layers, on the CPU, with --wandb where wandb is not
    installed: the JSON lines of the JAX CLI, a falling loss, the forward and
    gradient kernels not launched on the CPU, and a state dict that
    prepare_vae_codes loads."""
    save = str(tmp_path / "vae.pt")
    before = (fused_act.launches, fused_act.grad_launches)
    assert vae_cli.main(["--path", shards, "--size", "32", "--n_layers", "4", "--number_filters", "4",
                         "--latent_dim", "16", "--batch_size", "4", "--iter", "6", "--device", "cpu",
                         "--save", save, "--wandb"]) == 0
    assert (fused_act.launches, fused_act.grad_launches) == before
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("wandb unavailable (")
    logs = [json.loads(line) for line in lines[1:]]
    assert set(logs[0]) == {"Total", "Reconstruction", "Kullback Leibler Divergence", "step", "elapsed"}
    assert logs[-1]["failed"] is False and logs[-1]["Score"] == logs[0]["Total"]
    model = tae.LogCoshVAE(size=32, hidden_dims=(4, 8, 16, 32), latent_dim=16)
    model.load_state_dict(torch.load(save, weights_only=True))
    assert sum(1 for m in model.modules() if isinstance(m, tae.ConvBN)) == 8


def test_vae_cli_default_size_raises(shards):
    """The JAX CLI's default --size 128 with 5 layers decodes to 64^2 and its
    loss fails to broadcast; the port refuses it before the first step."""
    with pytest.raises(ValueError, match="--size 64"):
        vae_cli.main(["--path", shards, "--iter", "1", "--device", "cpu"])


def test_prepare_vae_codes_matches_jax(tmp_path, shards):
    """encode_dataset over 10 images at batch 4 (the last batch padded with
    two repeats): the JAX codes and the port's within 1e-5 of the largest,
    the same shard files and record counts, and the port's shard writer
    byte-equal to JAX's given the JAX codes."""
    jm = jae.LogCoshVAE(hidden_dims=(4, 8, 16, 32), latent_dim=16)
    variables = jm.init({"params": jax.random.PRNGKey(1), "latent": jax.random.PRNGKey(2)},
                        jnp.zeros((1, 3, SIZE, SIZE)))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    tm = tae.LogCoshVAE(size=SIZE, hidden_dims=(4, 8, 16, 32), latent_dim=16)
    tm.load_state_dict(vae_state_dict_from_jax(variables, tm))
    before = {k: v.clone() for k, v in tm.state_dict().items()}

    jdir, tdir, wdir = (str(tmp_path / d) for d in ("jax", "torch", "rewrite"))
    assert jax_encode_dataset(jm, variables, shards, SIZE, jdir, batch=4, shard_size=4) == 10
    assert encode_dataset(tm, shards, SIZE, tdir, batch=4, shard_size=4) == 10
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)  # running statistics untouched

    def read(d):
        return {f: [pickle.loads(RecordShardReader(os.path.join(d, f)).get(i))
                    for i in range(len(RecordShardReader(os.path.join(d, f))))] for f in sorted(os.listdir(d))}

    jcodes, tcodes = read(jdir), read(tdir)
    assert list(jcodes) == list(tcodes) == ["codes-0-0000.mrec", "codes-0-0001.mrec", "codes-0-0002.mrec"]
    for f in jcodes:
        assert [c.dtype for c in tcodes[f]] == [np.float32] * len(jcodes[f])
        close(np.stack(tcodes[f]), np.stack(jcodes[f]), what=f)
    write_code_shards([c for f in jcodes for c in jcodes[f]], wdir, shard_size=4)
    for f in jcodes:
        with open(os.path.join(jdir, f), "rb") as a, open(os.path.join(wdir, f), "rb") as b:
            assert a.read() == b.read(), f


def test_prepare_vae_codes_cli_reads_a_state_dict(tmp_path, shards):
    """The CLI with --vae_ckpt (a port state dict of the default LogCoshVAE)
    writes the codes that encode_dataset gives for those weights."""
    model = load_vae(None, SIZE, 32, "cpu")
    torch.save(model.state_dict(), tmp_path / "vae.pt")
    assert codes_main(["--path", shards, "--size", str(SIZE), "--latent_dim", "32", "--batch", "4",
                       "--vae_ckpt", str(tmp_path / "vae.pt"), "--out", str(tmp_path / "a"), "--device", "cpu"]) == 0
    encode_dataset(model, shards, SIZE, str(tmp_path / "b"), batch=4)
    for f in os.listdir(tmp_path / "b"):
        assert (tmp_path / "a" / f).read_bytes() == (tmp_path / "b" / f).read_bytes()

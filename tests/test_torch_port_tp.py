"""maua_tpu_torch.parallel.tp against maua_tpu.parallel.tp on the CPU.

The generator is the one tests/test_tp.py shards (32^2, style_dim 32, two
mapping layers, channel multiplier 1, channel_max 64, constant input), its
JAX variables carried to the port by `generator_state_dict_from_jax`. Each
mesh runs as gloo processes, one per mesh position (`--coordinator` style:
tcp:// on a free localhost port), each limited to 90 s; every rank writes
what it computed, and the test holds it:

* the placements of every parameter against JAX's PartitionSpecs name by
  name (a StyledConv's modulated-conv weight sharded on its out-channels, dim
  1 of the port's [1, O, I, k, k] and dim 0 of JAX's [O, I, k, k]; its
  activation bias on dim 0; the rest replicated), and each rank's local
  slices;
* the sharded synthesis of a batch of 4 (the stored noise, as JAX's test
  runs it) against JAX's sharded synthesis on its 2 x 4 mesh of the 8 CPU
  devices, within 2e-4 as tests/test_tp.py holds it; every rank returns the
  whole batch;
* a forward with per-sample noise, per-sample truncation and activation maps
  against the port's unsharded generator on the same rank, within 1e-5;
* a forward with drawn noise (`randomize_noise`, the default) and the noise
  weights set to 0.5, each rank's `rng` seeded with seed + rank, against the unsharded generator with the
  first rank's seed, within 1e-5: every sample of the batch and every
  channel slice gets the noise map the unsharded generator draws for it.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from maua_tpu.models import Generator as JaxGenerator
from maua_tpu.parallel import generator_param_shardings as jax_shardings
from maua_tpu.parallel import get_2d_mesh as jax_mesh
from maua_tpu.parallel import shard_generator_params as jax_shard
from maua_tpu_torch import parallel
from maua_tpu_torch.io import generator_state_dict_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_LIMIT_S = 90
GEN_KW = dict(size=32, style_dim=32, n_mlp=2, channel_multiplier=1, constant_input=True, channel_max=64)

WORKER = r'''
import json, sys
import numpy as np, torch
from maua_tpu_torch import parallel
from maua_tpu_torch.models import Generator

out, port, rank, n_data, n_model = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])
torch.set_num_threads(1)
inp = np.load(f"{out}/inputs.npz")
g = Generator(**json.loads(sys.argv[6]))
g.load_state_dict(torch.load(f"{out}/g.pt"), strict=True)
parallel.maybe_initialize_distributed(f"127.0.0.1:{port}", n_data * n_model, rank, device="cpu")
try:
    mesh = parallel.get_2d_mesh(n_data, n_model, "cpu")
    placements = {k: [str(p) for p in v] for k, v in parallel.generator_param_shardings(g, mesh).items()}
    tp = parallel.shard_generator_params(g, mesh)
    local = {k: list(v.to_local().shape) for k, v in tp.generator.named_parameters() if hasattr(v, "to_local")}
    z = torch.from_numpy(inp["z"])
    img, _ = tp(z, randomize_noise=False)
    noise = [torch.from_numpy(inp[f"noise_{i}"]) for i in range(g.num_layers)]
    tl = g.mean_latent(torch.Generator().manual_seed(0), n_latent=64)
    trunc = torch.from_numpy(inp["trunc"])
    kw = dict(noise=noise, truncation=trunc, truncation_latent=tl, return_activation_maps=True)
    img2, maps = tp(z, **kw)
    want2, want_maps = g(z, **kw)
    err = max([float((img2 - want2).abs().max())] + [float((a - b).abs().max()) for a, b in zip(maps, want_maps)])
    scale = float(want2.abs().max())
    # drawn noise, with the noise weights set to 0.5 (they start at 0): each rank's rng
    # in another state (seed + rank); rank 0's draw is every rank's
    with torch.no_grad():
        for name, p in g.named_parameters():
            if name.endswith("noise.weight"):
                p.fill_(0.5)
    tp = parallel.shard_generator_params(g, mesh)
    img3, _ = tp(z, rng=torch.Generator().manual_seed(11 + rank))
    want3, _ = g(z, rng=torch.Generator().manual_seed(11))
    err_random = float((img3 - want3).abs().max())
    np.save(f"{out}/img_{rank}.npy", img.numpy())
    json.dump(dict(placements=placements, local=local, err=err, scale=scale, n_maps=len(maps), err_random=err_random,
                   scale_random=float(want3.abs().max())), open(f"{out}/rank_{rank}.json", "w"))
finally:
    parallel.shutdown_distributed()
'''


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_gen():
    gen = JaxGenerator(**GEN_KW)
    variables = jax.jit(gen.init)({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, jnp.zeros((1, 32)))
    return gen, variables


@pytest.fixture(scope="module")
def jax_tp_image(jax_gen):
    """JAX's sharded synthesis on its 2 x 4 mesh (tests/test_tp.py)."""
    gen, variables = jax_gen
    mesh = jax_mesh(2, 4)
    z = jax.random.normal(jax.random.PRNGKey(2), (4, 32))
    params = jax_shard(variables["params"], mesh)
    buffers = jax.device_put(variables["buffers"], NamedSharding(mesh, P()))

    @jax.jit
    def synth(p, b, z):
        return gen.apply({"params": p, "buffers": b}, z, randomize_noise=False)[0]

    return np.asarray(synth(params, buffers, jax.device_put(z, NamedSharding(mesh, P("data"))))), np.asarray(z)


def run_mesh(tmp, jax_gen, z, n_data, n_model):
    gen, variables = jax_gen
    np_vars = jax.tree_util.tree_map(np.asarray, variables)
    torch.save(generator_state_dict_from_jax(np_vars["params"], np_vars["buffers"]), os.path.join(tmp, "g.pt"))
    rng = np.random.default_rng(5)
    shapes = [np_vars["buffers"][f"noise_{i}"].shape for i in range(len(np_vars["buffers"]))]
    np.savez(os.path.join(tmp, "inputs.npz"), z=z, trunc=np.linspace(0.5, 1.0, 4, dtype=np.float32),
             **{f"noise_{i}": rng.standard_normal((4,) + s[1:]).astype(np.float32) for i, s in enumerate(shapes)})
    script = os.path.join(tmp, "worker.py")
    with open(script, "w") as f:
        f.write(WORKER)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    env.pop("JAX_PLATFORMS", None)
    port, world = free_port(), n_data * n_model
    procs = [subprocess.Popen([sys.executable, script, tmp, str(port), str(r), str(n_data), str(n_model), json.dumps(GEN_KW)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=RUN_LIMIT_S)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(json.load(open(os.path.join(tmp, f"rank_{r}.json"))), np.load(os.path.join(tmp, f"img_{r}.npy")))
            for r in range(world)]


MESHES = [(2, 2), (1, 4)]


@pytest.fixture(scope="module")
def runs(jax_gen, jax_tp_image, tmp_path_factory):
    _, z = jax_tp_image
    return {m: run_mesh(str(tmp_path_factory.mktemp(f"tp_{m[0]}x{m[1]}")), jax_gen, z, *m) for m in MESHES}


def port_name(path: tuple) -> str:
    """The port's state-dict key of a JAX Generator param path."""
    top, rest = path[0], list(path[1:])
    if top == "style":
        return f"style.{int(rest[0].split('_')[1]) + 1}.{rest[1]}"
    if top == "g_input":
        return "input.input"
    head = top.replace("convs_", "convs.").replace("to_rgbs_", "to_rgbs.")
    if rest == ["act_bias"]:
        return f"{head}.activate.bias"
    return ".".join([head] + rest)


@pytest.mark.parametrize("mesh", MESHES)
def test_shardings_match_jax_specs(runs, jax_gen, mesh):
    _, variables = jax_gen
    specs = jax_shardings(variables["params"], jax_mesh(*mesh))
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    want = {port_name(tuple(k.key for k in path)): s.spec for path, s in flat}
    n_model = mesh[1]
    for info, _ in runs[mesh]:
        got = info["placements"]
        params = {k: v for k, v in got.items() if not (k.startswith("noises.") or k.endswith(".kernel"))}
        assert set(params) == set(want)
        assert all(v[0] == "R" for v in got.values())  # nothing is split over data
        for name, spec in want.items():
            if spec == P():
                assert params[name] == ["R", "R"], name
            elif name.endswith("conv.weight"):  # JAX [O, I, k, k] on O, the port's [1, O, I, k, k] on O
                assert spec == P("model", None, None, None) and params[name] == ["R", "S(1)"], name
            else:
                assert spec == P("model") and params[name] == ["R", "S(0)"], name
        assert sum(v[1] != "R" for v in params.values()) == 2 * 7  # every StyledConv: weight and bias
        assert info["local"]["conv1.conv.weight"] == [1, 64 // n_model, 64, 3, 3]
        assert info["local"]["convs.0.activate.bias"] == [64 // n_model]


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_synthesis_matches_jax_tp(runs, jax_tp_image, mesh):
    want, _ = jax_tp_image
    for info, img in runs[mesh]:
        assert img.shape == (4, 3, 32, 32)
        np.testing.assert_allclose(img, want, atol=2e-4, rtol=2e-4)
        np.testing.assert_array_equal(img, runs[mesh][0][1])  # every rank holds the whole batch
        assert info["err"] <= 1e-5 * max(info["scale"], 1.0) and info["n_maps"] == 7


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_drawn_noise_matches_unsharded(runs, mesh):
    for info, _ in runs[mesh]:
        assert info["err_random"] <= 1e-5 * max(info["scale_random"], 1.0), info["err_random"]


def test_get_2d_mesh_needs_a_device_and_a_group():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            parallel.get_2d_mesh(1, 1)
    with pytest.raises(ValueError, match="process group"):
        parallel.get_2d_mesh(1, 1, "cpu")
    assert parallel.MODEL_AXIS == "model"

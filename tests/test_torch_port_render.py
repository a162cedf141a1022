"""maua_tpu_torch.render against maua_tpu.render on the CPU: `_pack_frames`
(square, widescreen and portrait crop + bilinear resize) and a whole
`render()` with a padded tail batch, tensor truncation, explicit noise and one
rewrite. Frames are captured by replacing each package's `frames.VideoWriter`
with a collecting sink for the test; uint8 frames agree to +-1."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maua_tpu.render.frames as jax_frames
import maua_tpu_torch.render.frames as torch_frames
from maua_tpu.io import generator_state_dict_to_torch
from maua_tpu.io import load_generator as jax_load_generator
from maua_tpu.models import Generator as JaxGenerator
from maua_tpu.models import noise_shapes
from maua_tpu.reactive.rewrite import Rewrite as JaxRewrite
from maua_tpu_torch.io import load_generator
from maua_tpu_torch.reactive import Rewrite


@pytest.mark.parametrize(
    "shape,out_size",
    [((2, 3, 16, 16), None), ((1, 3, 1024, 2048), 1920), ((1, 3, 2048, 1024), 1080)],
    ids=["square", "widescreen", "portrait"],
)
def test_pack_frames_matches_jax(shape, out_size):
    img = np.random.RandomState(0).uniform(-1.2, 1.2, shape).astype(np.float32)
    got = torch_frames._pack_frames(torch.from_numpy(img), out_size).numpy()
    want = np.asarray(jax_frames._pack_frames(jnp.asarray(img), out_size))
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    gen = JaxGenerator(size=32, style_dim=64, n_mlp=2, channel_max=32, constant_input=True)
    v = gen.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, jnp.zeros((1, 64)))
    rng = np.random.RandomState(0)
    v = {
        "params": jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.2 * rng.randn(*a.shape).astype(np.float32), v["params"]),
        "buffers": {k: rng.randn(*np.shape(b)).astype(np.float32) for k, b in v["buffers"].items()},
    }
    sd = generator_state_dict_to_torch(v, gen)
    path = tmp_path_factory.mktemp("ckpt") / "g.pt"
    torch.save({"g_ema": {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in sd.items()}}, path)
    return str(path)


def _sink(frames):
    class Sink:
        def __init__(self, output_file, width, height, fps, **kw):
            self.shape = (height, width, 3)

        def write(self, frame):
            assert frame.shape == self.shape
            frames.append(np.array(frame))

        def close(self):
            pass

    return Sink


def test_render_matches_jax(checkpoint, monkeypatch, tmp_path):
    n_frames, d = 5, 64
    jg, jvars = jax_load_generator(checkpoint)
    tg = load_generator(checkpoint, device="cpu")
    rng = np.random.RandomState(1)
    latents = rng.randn(n_frames, tg.n_latent, d).astype(np.float32)
    shapes = noise_shapes(32)
    noise = [None if i % 2 else rng.randn(n_frames, 1, s[2], s[3]).astype(np.float32) for i, s in enumerate(shapes)]
    trunc = np.linspace(0.5, 1.0, n_frames).astype(np.float32)
    tl = rng.randn(1, d).astype(np.float32)
    mod = np.linspace(0.0, 1.0, n_frames).astype(np.float32)

    def transform(w, m):  # jnp and torch alike
        return w * (1 + 0.5 * m.mean())

    common = dict(
        latents=latents, noise=noise, batch_size=4, fps=4,
        truncation=trunc, truncation_latent=tl,
    )
    jax_out, torch_out = [], []
    monkeypatch.setattr(jax_frames, "VideoWriter", _sink(jax_out))
    monkeypatch.setattr(torch_frames, "VideoWriter", _sink(torch_out))
    jax_frames.render(
        jg, jvars, output_file=str(tmp_path / "j.mp4"),
        rewrites=[JaxRewrite("convs_1/conv/weight", transform, mod)], **common,
    )
    torch_frames.render(
        tg, None, output_file=str(tmp_path / "t.mp4"), device="cpu",
        rewrites=[Rewrite("convs.1.conv.weight", transform, mod)], **common,
    )
    assert len(torch_out) == len(jax_out) == n_frames
    got, want = np.stack(torch_out).astype(np.int16), np.stack(jax_out).astype(np.int16)
    assert np.abs(got - want).max() <= 1
    assert got.std() > 0  # frames carry an image, not a constant


def test_render_refuses_mesh_and_wrong_device(checkpoint, tmp_path):
    tg = load_generator(checkpoint, device="cpu")
    latents = np.zeros((2, tg.n_latent, 64), np.float32)
    with pytest.raises(ValueError, match="mesh"):  # mesh= runs (test_torch_port_parallel.py) from the render device
        torch_frames.render(tg, None, latents, [], str(tmp_path / "x.mp4"), mesh=["meta", "cpu"], device="cpu")
    with pytest.raises(ValueError, match="truncation_latent"):
        torch_frames.render(tg, None, latents, [], str(tmp_path / "x.mp4"), truncation=0.7, device="cpu")

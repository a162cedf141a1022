"""maua_tpu_torch's inference tools against maua_tpu's on the CPU (LPIPS is
in test_torch_port_lpips.py): the projector's helpers and three
projection steps fed the JAX package's draws, sample(), the latent
selection sampler and generate_and_select(), the picker's HTTP round trip,
the segmented noise, the manipulation bends and a whole interpolation video.

The port takes its random numbers from a `draws` object; `Replay` hands it
the JAX package's draws in the order the port asks for them. Tolerances:
1e-5 for LPIPS and the noise timelines, 3e-5 for the bends' modulations, 1e-4 for
latents, images, bent activations and the projected latent and noise maps,
1 uint8 level for frames and PNGs."""

import importlib
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import maua_tpu.pipeline.interpolate as jinterp
import maua_tpu.pipeline.projector as jproj
import maua_tpu.pipeline.select_latents as jsel
import maua_tpu.render.frames as jax_frames
import maua_tpu_torch.pipeline.interpolate as tinterp
import maua_tpu_torch.pipeline.projector as tproj
import maua_tpu_torch.pipeline.select_latents as tsel
import maua_tpu_torch.render.frames as torch_frames
from maua_tpu.io import load_generator as jax_load_generator
from maua_tpu.models import Generator as JaxGenerator
from maua_tpu.models import noise_shapes
from maua_tpu.pipeline.sample import sample as jax_sample
from maua_tpu_torch.draws import Draws
from maua_tpu_torch.eval import LPIPS
from maua_tpu_torch.io import generator_state_dict_from_jax, load_generator
from maua_tpu_torch.pipeline.sample import sample
from maua_tpu_torch.reactive import Bend

tar = importlib.import_module("maua_tpu_torch.audio")


class Replay:
    """A `draws` object that hands out precomputed arrays (here the JAX
    package's draws) in order, checking each shape. Called like the `Draws`
    class it returns itself, so it can stand in for that class too."""

    def __init__(self, arrays):
        self.arrays = [np.asarray(a, np.float32) for a in arrays]

    def __call__(self, seed, device=None):
        return self

    def _next(self, shape):
        a = self.arrays.pop(0)
        assert a.shape == tuple(shape), (a.shape, shape)
        return torch.from_numpy(a.copy())

    normal = uniform = lambda self, *shape: self._next(shape)


def close(got, want, atol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= atol, f"max abs {err} > {atol}"


def sink(frames):
    class Sink:
        def __init__(self, output_file, width, height, fps, **kw):
            self.shape = (height, width, 3)

        def write(self, frame):
            assert frame.shape == self.shape
            frames.append(np.array(frame))

        def close(self):
            pass

    return Sink


@pytest.fixture(autouse=True)
def cpu_audio(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    smf = tar.get_SMF()
    tar.set_device("cpu")
    yield
    tar.set_SMF(smf)
    tar.set_device(None)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A 32^2 generator (style_dim 512, n_mlp 8, channel_max 32) with JAX's
    initial weights moved by 0.2 N(0, 1) and random noise buffers, so the
    noise weights and biases are not zero."""
    gen = JaxGenerator(size=32, constant_input=True, channel_max=32)
    v = gen.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, jnp.zeros((1, 512)))
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.2 * rng.randn(*np.shape(a)).astype(np.float32), v["params"])
    buffers = {k: rng.randn(*np.shape(b)).astype(np.float32) for k, b in v["buffers"].items()}
    p = tmp_path_factory.mktemp("ckpt") / "g32.pt"
    torch.save({"g_ema": generator_state_dict_from_jax(params, buffers)}, str(p))
    return str(p)


# ---------------------------------------------------------------- LPIPS
def torchvision_features(net: str, seed: int = 0) -> dict:
    """A torchvision-layout backbone state dict (He-normal convs, small
    biases) plus classifier keys, which the loaders must ignore."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in LPIPS(net).state_dict().items():
        if k.startswith("features."):
            fan = int(np.prod(v.shape[1:])) if v.ndim > 1 else 1
            scale = np.sqrt(2.0 / fan) if v.ndim > 1 else 0.05
            sd[k] = (scale * rng.standard_normal(tuple(v.shape))).astype(np.float32)
    sd["classifier.0.weight"] = np.zeros((4, 4), np.float32)
    return sd


def heads(net: str, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    return {f"lin{i}.model.1.weight": (rng.random((1, c, 1, 1)) - 0.2).astype(np.float32)
            for i, c in enumerate([64, 128, 256, 512, 512] if net == "vgg" else [64, 192, 384, 256, 256])}


# ---------------------------------------------------------------- projector
def test_projector_helpers_match_jax():
    rng = np.random.default_rng(3)
    noises = [rng.standard_normal((2, 1, s, s)).astype(np.float32) for s in (4, 8, 16, 32)]
    close(tproj.noise_regularize([torch.from_numpy(n) for n in noises]),
          jproj.noise_regularize([jnp.asarray(n) for n in noises]), 1e-7)
    for got, want in zip(tproj.noise_normalize([torch.from_numpy(3 * n + 1) for n in noises]),
                         jproj.noise_normalize([jnp.asarray(3 * n + 1) for n in noises])):
        close(got, want, 1e-5)
    for step in (0, 1, 5, 37, 80, 99):
        assert abs(tproj._lr_schedule(step, 100, 0.1) - float(jproj._lr_schedule(step, 100, 0.1))) < 1e-8


def jax_project_draws(rng, size: int, b: int, n_latent: int, style_dim: int, n_steps: int) -> list:
    """The JAX projector's draws in the port's order: 10,000 z, one noise
    map per layer, one latent-noise draw per step."""
    k_stat, k_rng = jax.random.split(rng)
    out = [jax.random.normal(k_stat, (10_000, style_dim))]
    out += [jax.random.normal(jax.random.fold_in(k_rng, i), (b,) + s[1:]) for i, s in enumerate(noise_shapes(size))]
    for _ in range(n_steps):
        k_rng, key = jax.random.split(k_rng)
        out.append(jax.random.normal(key, (b, n_latent, style_dim)))
    return out


def test_project_matches_jax(ckpt):
    """Three steps (the first at lr 0) of the default 64^2-MSE projection
    from the JAX package's draws: latent and every noise map within 1e-4,
    the logged losses within 1e-4 relative (the noise penalty, weighted by
    1e3, sums squared means of maps that differ by ~1e-6 after two Adam
    updates)."""
    jg, jv = jax_load_generator(ckpt)
    tg = load_generator(ckpt, device="cpu")
    z = np.random.default_rng(4).standard_normal((1, 512)).astype(np.float32)
    target = np.asarray(jg.apply(jv, jnp.asarray(z), randomize_noise=False)[0])
    rng = jax.random.PRNGKey(3)
    lat_j, noises_j, hist_j = jproj.project(jg, jv, jnp.asarray(target), n_steps=3, lr=0.1, rng=rng, log_every=1,
                                            noise_regularize_weight=1e3)
    draws = Replay(jax_project_draws(rng, 32, 1, tg.n_latent, 512, 3))
    lat_t, noises_t, hist_t = tproj.project(tg, torch.from_numpy(target), n_steps=3, lr=0.1, draws=draws,
                                            log_every=1, noise_regularize_weight=1e3)
    assert not draws.arrays
    close(lat_t, lat_j, 1e-4)
    assert len(noises_t) == len(noises_j) == tg.num_layers
    for a, b in zip(noises_t, noises_j):
        close(a, b, 1e-4)
    for a, b in zip(hist_t, hist_j):
        assert a["step"] == b["step"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        np.testing.assert_allclose(a["dist"], b["dist"], rtol=1e-4)


def test_project_lowers_the_distance(ckpt):
    """30 steps from the port's own draws lower the distance to a generator
    sample (the JAX package's test, tests/test_tooling.py)."""
    tg = load_generator(ckpt, device="cpu")
    with torch.no_grad():
        target, _ = tg(torch.from_numpy(np.random.default_rng(5).standard_normal((1, 512)).astype(np.float32)),
                       randomize_noise=False)
    latent, noises, history = tproj.project(tg, target, n_steps=30, lr=0.2, log_every=5, noise_regularize_weight=1e3,
                                            draws=Draws(0, "cpu"))
    assert latent.shape == (1, tg.n_latent, 512) and len(noises) == tg.num_layers
    assert history[-1]["dist"] < history[0]["dist"]


# ---------------------------------------------------------------- sample, select_latents
def jax_chain(seed: int, n: int, shape) -> list:
    """n draws of `shape` from the split chain of PRNGKey(seed)."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(n):
        rng, key = jax.random.split(rng)
        out.append(jax.random.normal(key, shape))
    return out


def test_sample_matches_jax(ckpt, tmp_path):
    """3 pictures at batch 2 with truncation 0.7 (mean latent from seed + 1):
    PNGs within 1 level, and the grid."""
    out_j = jax_sample(ckpt, pics=3, sample_batch=2, truncation=0.7, truncation_mean=256, out_dir=str(tmp_path / "j"), seed=2)
    out_t = sample(ckpt, pics=3, sample_batch=2, truncation=0.7, truncation_mean=256, out_dir=str(tmp_path / "t"), seed=2,
                   device="cpu", draws=Replay(jax_chain(2, 2, (2, 512))),
                   mean_draws=Replay([jax.random.normal(jax.random.PRNGKey(3), (256, 512))]))
    for name in ("000000.png", "000001.png", "000002.png", "grid.png"):
        a = np.asarray(Image.open(os.path.join(out_t, name)), np.int16)
        b = np.asarray(Image.open(os.path.join(out_j, name)), np.int16)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, name
    assert not os.path.exists(os.path.join(out_t, "000003.png"))


def test_select_latents_matches_jax(ckpt, tmp_path):
    """The checkpoint sampler over two calls (5 then 3 latents, batch 2, the
    last chunk padded) and generate_and_select's files against the JAX
    package's, from its draws."""
    j_sample = jsel.make_checkpoint_sampler(ckpt, truncation=0.6, seed=1, batch=2)
    mean = [jax.random.normal(jax.random.PRNGKey(2), (2**14, 512))]
    chain = jax.random.PRNGKey(1)
    zs = []
    for n in (5, 3):
        chain, k = jax.random.split(chain)
        zs.append(jax.random.normal(k, (n, 512)))
    t_sample = tsel.make_checkpoint_sampler(ckpt, truncation=0.6, seed=1, batch=2, device="cpu", draws=Replay(zs),
                                            mean_draws=Replay(mean))
    for n in (5, 3):
        wj, ij = j_sample(n)
        wt, it = t_sample(n)
        close(wt, wj, 1e-4)
        close(it, ij, 1e-4)
        assert it.shape == (n, 3, 32, 32)

    picks = {"intro": [0, 2], "drop": [1, 3]}
    oj = jsel.generate_and_select(ckpt, n=4, out_dir=str(tmp_path / "j"), picks=picks, seed=3)
    chain, k = jax.random.split(jax.random.PRNGKey(3))
    ot = tsel.generate_and_select(ckpt, n=4, out_dir=str(tmp_path / "t"), picks=picks, seed=3, device="cpu",
                                  draws=Replay([jax.random.normal(k, (4, 512))]),
                                  mean_draws=Replay([jax.random.normal(jax.random.PRNGKey(4), (2**14, 512))]))
    assert sorted(ot) == sorted(oj) == ["all", "drop", "intro"]
    for key in ot:
        close(np.load(ot[key]), np.load(oj[key]), 1e-4)
    assert os.path.exists(tmp_path / "t" / "sheet.jpg") and os.path.exists(tmp_path / "t" / "intro_sheet.jpg")
    assert tsel.main(["--ckpt", ckpt, "--n", "3", "--out", str(tmp_path / "cli"), "--pick", "a=0,2", "--device", "cpu"]) == 0
    assert np.load(tmp_path / "cli" / "a_latents.npy").shape == (2, 8, 512)


def test_latent_picker_http_workflow(ckpt, tmp_path):
    """The web picker over real HTTP, backed by the port's checkpoint sampler
    on the CPU: gallery state, an image, intro / drop selection and clearing,
    a new batch, save, and an error as HTTP 500."""
    picker = tsel.LatentPicker(tsel.make_checkpoint_sampler(ckpt, batch=4, device="cpu"), str(tmp_path / "sel"), n_per_batch=4)
    picker.new_batch()
    srv = tsel.make_picker_server(picker, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=10) as r:
            return r.headers.get_content_type(), r.read()

    def post(path, obj=None):
        req = urllib.request.Request(base + path, data=json.dumps(obj or {}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            return json.loads(r.read())

    try:
        ctype, html = get("/")
        assert ctype == "text/html" and b"latent picker" in html
        assert len(json.loads(get("/state")[1])["items"]) == 4
        ctype, jpg = get("/img/2.jpg")
        assert ctype == "image/jpeg" and jpg[:2] == b"\xff\xd8"
        post("/select", {"index": 0, "set": "intro"})
        post("/select", {"index": 1, "set": "drop"})
        post("/select", {"index": 2, "set": "intro"})
        post("/select", {"index": 2, "set": None})
        state = json.loads(get("/state")[1])
        assert state["counts"] == {"intro": 1, "drop": 1}
        assert post("/batch")["indices"] == [4, 5, 6, 7]
        post("/select", {"index": 5, "set": "intro"})
        saved = post("/save")
        intro = np.load(saved["intro"])
        assert intro.shape == (2, 8, 512)
        np.testing.assert_array_equal(intro[0], np.load(saved["all"])[0])
        assert os.path.exists(tmp_path / "sel" / "intro_sheet.jpg")
        with pytest.raises(urllib.error.HTTPError) as e:
            post("/select", {"index": 99, "set": "intro"})
        assert e.value.code == 500
    finally:
        srv.shutdown()
        t.join(timeout=5)
    assert not t.is_alive()


# ---------------------------------------------------------------- interpolate
@pytest.mark.parametrize("stylegan1", [False, True])
def test_segmented_noise_matches_jax(stylegan1):
    """numpy's RandomState draws in both; the temporal filters within 1e-5."""
    got = tinterp.segmented_noise(24, 32, 32, stylegan1, moving_frames=10, mid_start=6, seed=3, device="cpu")
    want = jinterp.segmented_noise(24, 32, 32, stylegan1, moving_frames=10, mid_start=6, seed=3)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        close(a, b, 1e-5)


def test_build_manipulations_matches_jax():
    """out_size 64 from a 32^2 generator (the layer-0 pad and noise) plus the
    translate, zoom and rotate timelines: each bend's layer, its modulation
    within 3e-5 (the zoom ramp is a 73-tap fp32 filter of values up to 4,
    renormalised by its range) and its transform on a random N(0, 1) activation with that
    modulation within 1e-4 (each package samples at its own modulation, and
    a bilinear sample moves by the coordinate's rounding times the
    activation's slope)."""
    got = tinterp.build_manipulations(12, 64, 32, translate_layer=1, zoom_layer=2, rotate_layer=3, seed=2, device="cpu")
    want = jinterp.build_manipulations(12, 64, 32, translate_layer=1, zoom_layer=2, rotate_layer=3, seed=2)
    assert [b.layer for b in got] == [b.layer for b in want] == [0, 0, 1, 2, 3]
    rng = np.random.default_rng(6)
    for i, (tb, jb) in enumerate(zip(got, want)):
        assert isinstance(tb, Bend)
        x = rng.standard_normal((4, 8, 4, 4) if i == 0 else (4, 8, 8, 8)).astype(np.float32)  # padded to 8x8 by bend 0
        mod_t = None if tb.modulation is None else tb.modulation[3:7]
        mod_j = None if jb.modulation is None else np.asarray(jb.modulation)[3:7]
        if mod_t is not None:
            close(tb.modulation, jb.modulation, 3e-5)
        close(tb.transform(torch.from_numpy(x), mod_t), jb.transform(jnp.asarray(x), mod_j), 1e-4)


def test_interpolation_video_matches_jax(ckpt, monkeypatch, tmp_path):
    """A 12-frame spline interpolation at 32^2 from a latents file, with
    segmented noise, truncation 1 and translate / zoom / rotate bends: frames
    within 1 level; then the CLI with its own draws and a slerp."""
    sel = str(tmp_path / "sel.npy")
    np.save(sel, 0.5 * np.random.default_rng(7).standard_normal((4, 8, 512)).astype(np.float32))
    jax_out, torch_out = [], []
    monkeypatch.setattr(jax_frames, "VideoWriter", sink(jax_out))
    monkeypatch.setattr(torch_frames, "VideoWriter", sink(torch_out))
    common = dict(duration=1.5, fps=8, batch=4, noise_mode="segmented", latents_file=sel, translate_layer=2,
                  zoom_layer=3, rotate_layer=4, seed=1)
    jinterp.interpolation_video(ckpt, output_file=str(tmp_path / "j.mp4"), **common)
    out = tinterp.interpolation_video(ckpt, output_file=str(tmp_path / "t.mp4"), device="cpu", **common)
    assert out == str(tmp_path / "t.mp4")
    assert len(torch_out) == len(jax_out) == 12
    got, want = np.stack(torch_out).astype(np.int16), np.stack(jax_out).astype(np.int16)
    assert np.abs(got - want).max() <= 1 and got.std() > 0

    torch_out.clear()
    assert tinterp.main(["--ckpt", ckpt, "--n_latents", "3", "--n_frames", "6", "--fps", "4", "--batch", "4",
                         "--interp", "slerp", "--truncation", "0.7", "--device", "cpu",
                         "--output_file", str(tmp_path / "cli.mp4")]) == 0
    assert len(torch_out) == 6

"""maua_tpu_torch's StyleGAN1 and TF-pickle ingestion against maua_tpu's on
the CPU: the G_style mapping, synthesis (both up-conv paths: nearest upscale
below 64^2, the transposed conv of the 4-tap summed weight from 64^2 up),
first-8-layer truncation, the widescreen and 512-from-1024 constants and the
stored noise buffers against `StyleGAN1.apply`; the JAX variables carried
across by stylegan1_state_dict_from_jax; a TF `Gs` pickle against
`load_tf_generator`; and generate(stylegan1=True) and
interpolation_video(stylegan1=True) at 32^2 against the JAX package's, fed
its draws.

Tolerances: 1e-4 for latents and images (fp32 convs in two libraries over
5-7 blocks whose instance norms rescale every layer to unit variance), exact
equality for state dicts, 1 uint8 level for video frames."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch
from test_stylegan1 import fabricate_sg1_sd
from test_tf_pkl import fabricate_tf_pkl

import maua_tpu.audio as jar
import maua_tpu.pipeline as jpipe
import maua_tpu.pipeline.interpolate as jinterp
import maua_tpu.render.frames as jax_frames
import maua_tpu_torch.audio as tar
import maua_tpu_torch.pipeline as tpipe
import maua_tpu_torch.pipeline.interpolate as tinterp
import maua_tpu_torch.render.frames as torch_frames
from maua_tpu.io.tf_pkl import load_tf_generator as jax_load_tf_generator
from maua_tpu.models.stylegan1 import stylegan1_variables_from_torch
from maua_tpu_torch.draws import Draws
from maua_tpu_torch.io import generator_state_dict_from_jax, generator_state_dict_from_tf, load_tf_generator
from maua_tpu_torch.io import load_tf_pickle_networks, stylegan1_state_dict_from_jax
from maua_tpu_torch.models import StyleGAN1, load_stylegan1
from test_torch_port_generate import click_track, numpy_noise, sink
from test_torch_port_inference import Replay

jdefaults = importlib.import_module("maua_tpu.pipeline.defaults")
tdefaults = importlib.import_module("maua_tpu_torch.pipeline.defaults")
tgenerate = importlib.import_module("maua_tpu_torch.pipeline.generate")  # the module, not the function

SR = 22050


def close(got, want, atol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= atol, f"max abs {err} > {atol}"


def sg1_sd(size: int, seed: int = 0) -> dict:
    """fabricate_sg1_sd with non-zero biases and noise weights, so every
    parameter reaches the image, except the up-convs' biases: the JAX package
    adds none on its fused path and adds it before the zero-padded blur on the
    other (maua_tpu/models/stylegan1.py), where the port, as NVlabs' G_style,
    adds it after the blur (tests/test_torch_port_stylegan1_reference.py)."""
    sd = fabricate_sg1_sd(size=size, seed=seed)
    rng = np.random.RandomState(seed + 100)
    for k, v in sd.items():
        if k.endswith("noise.weight"):
            sd[k] = (0.5 * rng.randn(*v.shape)).astype(np.float32)
        elif k.endswith("bias"):
            sd[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
        if k.endswith("conv0_up.bias"):
            sd[k] = np.zeros_like(sd[k])
    return sd


def port_sg1(sd: dict, jvars: dict, output_size=None) -> StyleGAN1:
    """The port's StyleGAN1 from the same G_style state dict and JAX's noise buffers."""
    sd = dict(sd)
    sd.update({f"noises.{k}": np.asarray(v) for k, v in jvars["buffers"].items()})
    return StyleGAN1.from_state_dict(sd, output_size=output_size).eval()


@pytest.fixture(autouse=True)
def isolated(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    smf_j, smf_t = jar.get_SMF(), tar.get_SMF()
    tar.set_device("cpu")
    yield
    jar.set_SMF(smf_j)
    tar.set_SMF(smf_t)
    tar.set_device(None)


@pytest.fixture(scope="module")
def sg1_128():
    sd = sg1_sd(128)
    model, jvars = stylegan1_variables_from_torch(sd, noise_rng=jax.random.PRNGKey(5))
    return sd, model, jvars


# ---------------------------------------------------------------- the model
def test_sg1_mapping_and_synthesis_match_jax(sg1_128):
    """128^2 (64 -> 128 runs the transposed conv): W+ from z, images from z
    with the stored noise buffers and from W+ with explicit noise maps, and
    the JAX variables carried across by stylegan1_state_dict_from_jax."""
    sd, jm, jv = sg1_128
    tm = port_sg1(sd, jv)
    assert (tm.size, tm.num_layers, tm.n_latent) == (jm.size, jm.num_layers, jm.n_latent) == (128, 6, 18)
    z = np.random.default_rng(0).standard_normal((2, 512)).astype(np.float32)
    w_j = np.asarray(jm.apply(jv, jnp.asarray(z), map_latents=True))
    with torch.no_grad():
        close(tm(torch.from_numpy(z), map_latents=True), w_j, 1e-4)
        close(tm.map_latents(torch.from_numpy(z)), w_j, 1e-4)
        img_j = np.asarray(jm.apply(jv, jnp.asarray(z), input_is_latent=False, randomize_noise=False)[0])
        img_t, extra = tm(torch.from_numpy(z), input_is_latent=False, randomize_noise=False)
        assert extra is None
        close(img_t, img_j, 1e-4)
        assert img_t.std() > 0.05

        rng = np.random.default_rng(1)
        noise = [rng.standard_normal((2, 1, 4 * 2**i, 4 * 2**i)).astype(np.float32) for i in range(6)]
        img_j = np.asarray(jm.apply(jv, jnp.asarray(w_j), noise=[jnp.asarray(n) for n in noise])[0])
        close(tm(torch.from_numpy(w_j), noise=[torch.from_numpy(n) for n in noise])[0], img_j, 1e-4)

        carried = StyleGAN1.from_state_dict(stylegan1_state_dict_from_jax(jv["params"], jv["buffers"]))
        close(carried(torch.from_numpy(z), input_is_latent=False)[0],
              jm.apply(jv, jnp.asarray(z), input_is_latent=False)[0], 1e-4)


def test_sg1_truncation_matches_jax(sg1_128):
    """Truncation toward the mean latent lerps only the first 8 of 18
    latents, for a float and for a per-sample tensor; mean_latent of the same
    z agrees."""
    sd, jm, jv = sg1_128
    tm = port_sg1(sd, jv)
    rng = np.random.default_rng(2)
    w = rng.standard_normal((2, 18, 512)).astype(np.float32)
    mean_z = jax.random.normal(jax.random.PRNGKey(3), (256, 512))
    mean_j = np.asarray(jnp.mean(jm.apply(jv, mean_z, map_latents=True)[:, 0], axis=0, keepdims=True))
    with torch.no_grad():
        mean_t = tm.get_latent(torch.from_numpy(np.asarray(mean_z))).mean(dim=0, keepdim=True)
        close(mean_t, mean_j, 1e-4)
        for trunc in (0.5, np.array([0.3, 0.9], np.float32)):
            want = jm.apply(jv, jnp.asarray(w), truncation=trunc if isinstance(trunc, float) else jnp.asarray(trunc),
                            truncation_latent=jnp.asarray(mean_j))[0]
            got, _ = tm(torch.from_numpy(w), truncation=trunc if isinstance(trunc, float) else torch.from_numpy(trunc),
                        truncation_latent=torch.from_numpy(mean_j))
            close(got, want, 1e-4)
        # layers past the 8th are not truncated: changing them changes the image even at truncation 0
        w2 = w.copy()
        w2[:, 8:] += 1.0
        a, _ = tm(torch.from_numpy(w), truncation=0.0, truncation_latent=torch.from_numpy(mean_j))
        b, _ = tm(torch.from_numpy(w2), truncation=0.0, truncation_latent=torch.from_numpy(mean_j))
        assert float((a - b).abs().max()) > 1e-3


@pytest.mark.parametrize("size,output_size,const_hw,img_hw", [(32, 1920, (4, 8), (32, 64)), (1024, 512, (2, 2), (512, 512))])
def test_sg1_reshaped_constant_matches_jax(size, output_size, const_hw, img_hw):
    """A 1920-wide output widens the 4x4 constant to 4x8 (edge columns twice
    each side); 512 from a 1024 model (32 channels) crops its centre 2x2.
    Noise buffers follow the constant's shape; images within 1e-4, from the
    G_style state dict and from the JAX variables carried across."""
    sd = sg1_sd(size, seed=1)
    model, jv = stylegan1_variables_from_torch(sd, output_size=output_size, noise_rng=jax.random.PRNGKey(7))
    tm = port_sg1(sd, jv, output_size=output_size)
    carried = StyleGAN1.from_state_dict(stylegan1_state_dict_from_jax(jv["params"], jv["buffers"]))
    assert tm.const_hw == carried.const_hw == model.const_hw == const_hw
    z = np.random.default_rng(3).standard_normal((1, 512)).astype(np.float32)
    want = model.apply(jv, jnp.asarray(z), input_is_latent=False)[0]
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(z), input_is_latent=False)
        close(got, want, 1e-4)
        close(carried(torch.from_numpy(z), input_is_latent=False)[0], want, 1e-4)
    assert got.shape[2:] == img_hw
    assert getattr(tm.noises, f"noise_{tm.num_layers - 1}").shape[2:] == img_hw


def test_sg1_stored_noise_buffers(sg1_128):
    """Stored buffers (JAX's, carried across) drive the image when no noise
    is given; randomize_noise draws fresh maps from the generator given."""
    sd, jm, jv = sg1_128
    tm = port_sg1(sd, jv)
    _, jv2 = stylegan1_variables_from_torch(sd, noise_rng=jax.random.PRNGKey(6))
    tm2 = port_sg1(sd, jv2)
    z = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 512)).astype(np.float32))
    with torch.no_grad():
        a, b = tm(z, input_is_latent=False)[0], tm2(z, input_is_latent=False)[0]
        close(b, jm.apply(jv2, jnp.asarray(z.numpy()), input_is_latent=False)[0], 1e-4)
        assert float((a - b).abs().max()) > 1e-3
        r1 = tm(z, input_is_latent=False, randomize_noise=True, rng=torch.Generator().manual_seed(0))[0]
        r2 = tm(z, input_is_latent=False, randomize_noise=True, rng=torch.Generator().manual_seed(0))[0]
        assert torch.equal(r1, r2) and float((r1 - a).abs().max()) > 1e-3
    for i in range(tm.num_layers):
        np.testing.assert_array_equal(getattr(tm.noises, f"noise_{i}").numpy(), np.asarray(jv["buffers"][f"noise_{i}"]))


def test_load_stylegan1_checks_the_checkpoint(tmp_path):
    sd = sg1_sd(16)
    torch.save({"g_ema": {k: torch.from_numpy(v) for k, v in sd.items()}}, str(tmp_path / "g1.pt"))
    m = load_stylegan1(str(tmp_path / "g1.pt"), device="cpu")
    assert m.size == 16 and not any(p.requires_grad for p in m.parameters())
    torch.save({"g_ema": {"style.1.weight": torch.zeros(2, 2)}}, str(tmp_path / "g2.pt"))
    with pytest.raises(ValueError, match="StyleGAN1"):
        load_stylegan1(str(tmp_path / "g2.pt"), device="cpu")


# ---------------------------------------------------------------- TF pickle
def test_tf_pickle_matches_jax(tmp_path):
    """A 16^2 Gs pickle (style_dim 64, 2 mapping layers, 32 channels) read
    without dnnlib: the port's rosinality state dict equals the JAX
    ingestion's carried across by generator_state_dict_from_jax (the FIR
    kernel buffers aside), and the port's Generator from it draws the JAX
    generator's images."""
    p = str(tmp_path / "net.pkl")
    fabricate_tf_pkl(p, size=16, style_dim=64, n_mlp=2, ch=32)
    nets = load_tf_pickle_networks(p)
    assert "Gs" in nets and "G_mapping/Dense0/weight" in nets["Gs"].variables
    config, sd = generator_state_dict_from_tf(nets["Gs"])
    jg, jv = jax_load_tf_generator(p)
    want = generator_state_dict_from_jax(jv["params"], jv["buffers"])
    assert set(want) - set(sd) == {k for k in want if k.endswith(".kernel")}
    assert set(sd) <= set(want)
    for k in sd:
        assert torch.equal(sd[k], want[k]), k
    assert config["size"] == jg.size == 16 and config["style_dim"] == 64 and config["n_mlp"] == 2

    gen = load_tf_generator(p, device="cpu")
    z = np.random.default_rng(5).standard_normal((2, 64)).astype(np.float32)
    with torch.no_grad():
        got, _ = gen(torch.from_numpy(z), randomize_noise=False)
    close(got, jg.apply(jv, jnp.asarray(z), randomize_noise=False)[0], 1e-4)


# ---------------------------------------------------------------- generate / interpolate
@pytest.fixture(scope="module")
def sg1_ckpt(tmp_path_factory):
    p = tmp_path_factory.mktemp("sg1") / "g1_32.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sg1_sd(32, seed=3).items()}, str(p))
    return str(p)


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    p = tmp_path_factory.mktemp("audio") / "clicks.wav"
    scipy.io.wavfile.write(str(p), SR, (click_track() * 32767).astype(np.int16))
    return str(p)


def test_generate_stylegan1_matches_jax(sg1_ckpt, wav, monkeypatch, tmp_path):
    """generate(stylegan1=True) from a WAV at 32^2: latent_count z (JAX's
    draws) through the SG1 mapping, the default latents plugin, numpy noise
    for every block, truncation 1. Frames within 1 level; the W+ selection
    saved to workspace/ within 1e-4."""
    jax_out, torch_out = [], []
    monkeypatch.setattr(jax_frames, "VideoWriter", sink(jax_out))
    monkeypatch.setattr(torch_frames, "VideoWriter", sink(torch_out))
    common = dict(ckpt=sg1_ckpt, audio_file=wav, G_res=32, out_size=32, fps=4, duration=1.5, batch=4,
                  stylegan1=True, latent_count=8, seed=2, get_noise=numpy_noise)
    jpipe.generate(**common, initialize=jdefaults.initialize, output_file=str(tmp_path / "j.npy"))
    want_sel = np.load("workspace/last-latents.npy")
    monkeypatch.setattr(tgenerate, "Draws", Replay([jax.random.normal(jax.random.PRNGKey(2), (8, 512))]))
    tpipe.generate(**common, initialize=tdefaults.initialize, output_file=str(tmp_path / "t.npy"), device="cpu")
    close(np.load("workspace/last-latents.npy"), want_sel, 1e-4)
    assert want_sel.shape == (8, 18, 512)
    assert len(torch_out) == len(jax_out) == 6
    got, want = np.stack(torch_out).astype(np.int16), np.stack(jax_out).astype(np.int16)
    assert np.abs(got - want).max() <= 1 and got.std() > 0


def test_interpolation_video_stylegan1_matches_jax(sg1_ckpt, monkeypatch, tmp_path):
    """interpolation_video(stylegan1=True) at 32^2: 3 mapped latents (JAX's
    z), a spline loop, segmented noise from numpy for all four blocks and a
    truncation toward the mean latent (each package's own z, so the stored
    lerp is compared with the same mean: the port's mean latent is patched to
    the JAX one). Frames within 1 level."""
    jax_out, torch_out = [], []
    monkeypatch.setattr(jax_frames, "VideoWriter", sink(jax_out))
    monkeypatch.setattr(torch_frames, "VideoWriter", sink(torch_out))
    common = dict(n_latents=3, duration=2.0, fps=6, batch=4, G_res=32, stylegan1=True, noise_mode="segmented", seed=4)
    jinterp.interpolation_video(sg1_ckpt, output_file=str(tmp_path / "j.mp4"), **common)
    monkeypatch.setattr(tinterp, "Draws", Replay([jax.random.normal(jax.random.PRNGKey(4), (3, 512))]))
    out = tinterp.interpolation_video(sg1_ckpt, output_file=str(tmp_path / "t.mp4"), device="cpu", **common)
    assert out == str(tmp_path / "t.mp4")
    assert len(torch_out) == len(jax_out) == 12
    got, want = np.stack(torch_out).astype(np.int16), np.stack(jax_out).astype(np.int16)
    assert np.abs(got - want).max() <= 1 and got.std() > 0

    torch_out.clear()
    monkeypatch.setattr(tinterp, "Draws", Draws)
    assert tinterp.main(["--ckpt", sg1_ckpt, "--stylegan1", "--G_res", "32", "--n_latents", "2", "--n_frames", "4",
                         "--fps", "4", "--batch", "4", "--truncation", "0.7", "--device", "cpu",
                         "--output_file", str(tmp_path / "cli.mp4")]) == 0
    assert len(torch_out) == 4

"""maua_tpu_torch.pipeline against maua_tpu.pipeline on the CPU:
get_noise_range, the default plugin (its noise fed the JAX package's own
draws), one whole generate() from a WAV file to frames against the JAX
generate() (latents from a file, noise from numpy, frames within 1 uint8
level), and the port's own runs: tensor truncation, a bends plugin, rewrites
that leave the weights untouched, the CLI with a plugin file and OVERRIDE,
and the refusal to run without a card unless asked for the CPU or to take a
StyleGAN2 checkpoint as a StyleGAN1 one."""

import argparse
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io.wavfile
import torch

import maua_tpu.audio as jar
import maua_tpu.pipeline as jpipe
import maua_tpu.render.frames as jax_frames
import maua_tpu_torch.audio as tar
import maua_tpu_torch.pipeline as tpipe
import maua_tpu_torch.render.frames as torch_frames
from maua_tpu.models import Generator as JaxGenerator
from maua_tpu_torch.io import generator_state_dict_from_jax
from maua_tpu_torch.pipeline import cli as tcli
from maua_tpu_torch.reactive import Rewrite, translate_bend

jdefaults = importlib.import_module("maua_tpu.pipeline.defaults")
tdefaults = importlib.import_module("maua_tpu_torch.pipeline.defaults")
SR = 22050


@pytest.fixture(autouse=True)
def isolated(tmp_path, monkeypatch):
    """Each test in its own working directory (workspace/ caches), the port's
    audio package on the CPU, and both packages' SMF restored."""
    monkeypatch.chdir(tmp_path)
    smf_j, smf_t = jar.get_SMF(), tar.get_SMF()
    tar.set_device("cpu")
    yield
    jar.set_SMF(smf_j)
    tar.set_SMF(smf_t)
    tar.set_device(None)


def click_track(dur=2.0):
    """A tone, a decaying 55 Hz kick and a 1.5 kHz click on alternate beats
    at 120 bpm, and a little noise (test_torch_port_audio.py's track)."""
    n = int(SR * dur)
    y = 0.1 * np.sin(2 * np.pi * 440.0 * np.arange(n) / SR)
    kick = 0.6 * np.sin(2 * np.pi * 55.0 * np.arange(4000) / SR) * np.exp(-np.arange(4000) / 800.0)
    click = np.hanning(200) * np.sin(2 * np.pi * 1500.0 * np.arange(200) / SR)
    for k, s in enumerate(range(SR // 8, n - 4000, SR // 2)):
        if k % 2 == 0:
            y[s : s + 4000] += kick
        else:
            y[s : s + 200] += click
    y += 0.003 * np.random.default_rng(0).standard_normal(n)
    return y


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    p = tmp_path_factory.mktemp("audio") / "clicks.wav"
    scipy.io.wavfile.write(str(p), SR, (click_track() * 32767).astype(np.int16))
    return str(p)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A 32^2 generator (style_dim 512, n_mlp 8, channel_max 64) with JAX's
    initial weights, carried across by generator_state_dict_from_jax."""
    gen = JaxGenerator(size=32, constant_input=True, channel_max=64)
    v = gen.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, jnp.zeros((1, 512)))
    p = tmp_path_factory.mktemp("ckpt") / "g32.pt"
    torch.save({"g_ema": generator_state_dict_from_jax(v["params"], v["buffers"])}, str(p))
    return str(p)


@pytest.fixture(scope="module")
def latent_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("latents") / "sel.npy"
    np.save(p, 0.5 * np.random.default_rng(1).standard_normal((12, 8, 512)).astype(np.float32))
    return str(p)


def numpy_noise(height, width, scale, num_scales, args):
    """Noise timelines from a numpy seed: the same arrays for both packages."""
    return np.random.default_rng(scale).standard_normal((args.n_frames, 1, height, width)).astype(np.float32)


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


def close(got, want, atol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= atol, f"max abs {err} > {atol}"


@pytest.mark.parametrize("out_size,g_res,sg1", [(1024, 1024, False), (1920, 1024, False), (512, 1024, False), (32, 32, False), (1024, 1024, True)])
def test_get_noise_range_matches_jax(out_size, g_res, sg1):
    a, b, f = tpipe.get_noise_range(out_size, g_res, sg1)
    a_j, b_j, f_j = jpipe.get_noise_range(out_size, g_res, sg1)
    assert (a, b) == (a_j, b_j) and [f(s) for s in range(a, b)] == [f_j(s) for s in range(a, b)]


def plugin_args(n_frames=12, dur=2.0):
    y = click_track(dur).astype(np.float32)
    return (argparse.Namespace(audio=y, sr=SR, n_frames=n_frames, duration=dur),
            argparse.Namespace(audio=torch.from_numpy(y), sr=SR, n_frames=n_frames, duration=dur))


def test_default_plugin_matches_jax():
    """initialize (lo and hi onsets) and get_latents at 1e-4; get_noise at
    1e-5 on the JAX package's draws for the same (height, width, scale) and
    its onsets (it blends unit-variance noise by them, which scales their
    1e-4 up to the noise's amplitude)."""
    ja, ta = plugin_args()
    jdefaults.initialize(ja)
    tdefaults.initialize(ta)
    close(ta.lo_onsets, ja.lo_onsets, 1e-4)
    close(ta.hi_onsets, ja.hi_onsets, 1e-4)

    sel = 0.5 * np.random.default_rng(2).standard_normal((12, 4, 16)).astype(np.float32)
    close(tdefaults.get_latents(torch.from_numpy(sel), ta), jdefaults.get_latents(sel, ja), 1e-4)

    same_onsets = argparse.Namespace(lo_onsets=torch.from_numpy(np.array(ja.lo_onsets)),
                                     hi_onsets=torch.from_numpy(np.array(ja.hi_onsets)))
    for h, w, scale in ((4, 4, 0), (8, 64, 3), (16, 256, 7)):
        k1, k2 = jax.random.split(jax.random.PRNGKey(hash((h, w, scale)) % 2**31))
        noisy, smooth = (torch.from_numpy(np.array(jax.random.normal(k, (ta.n_frames, 1, h, w)))) for k in (k1, k2))
        close(tdefaults._noise_from(noisy, smooth, w, same_onsets), jdefaults.get_noise(h, w, scale, 9, ja), 1e-5)
        own = tdefaults.get_noise(h, w, scale, 9, ta)
        assert own.shape == (ta.n_frames, 1, h, w) and torch.equal(own, tdefaults.get_noise(h, w, scale, 9, ta))
    assert tdefaults.get_noise(4, 512, 0, 9, ta) is None


def test_generate_matches_jax(ckpt, wav, latent_file, monkeypatch, tmp_path):
    """WAV -> frames through both packages' generate(): default initialize and
    get_latents, latents from a file, numpy noise, truncation 1 (no device
    RNG on either side). Frames within 1 uint8 level."""
    jax_out, torch_out = [], []
    monkeypatch.setattr(jax_frames, "VideoWriter", sink(jax_out))
    monkeypatch.setattr(torch_frames, "VideoWriter", sink(torch_out))
    common = dict(ckpt=ckpt, audio_file=wav, G_res=32, out_size=32, fps=4, duration=1.5, batch=4,
                  latent_file=latent_file, get_noise=numpy_noise)
    jpipe.generate(**common, initialize=jdefaults.initialize, output_file=str(tmp_path / "j.npy"))
    out = tpipe.generate(**common, initialize=tdefaults.initialize, output_file=str(tmp_path / "t.npy"), device="cpu")
    assert out == str(tmp_path / "t.npy")
    assert len(torch_out) == len(jax_out) == 6
    got, want = np.stack(torch_out).astype(np.int16), np.stack(jax_out).astype(np.int16)
    assert np.abs(got - want).max() <= 1
    assert got.std() > 0
    np.testing.assert_array_equal(np.load("workspace/last-latents.npy"), np.load(latent_file))


def run(ckpt, wav, frames, monkeypatch, tmp_path, name, **kw):
    monkeypatch.setattr(torch_frames, "VideoWriter", sink(frames))
    kw = {**dict(ckpt=ckpt, audio_file=wav, G_res=32, out_size=32, fps=2, duration=1.5, batch=2,
                 latent_count=8, device="cpu", output_file=str(tmp_path / name)), **kw}
    return tpipe.generate(**kw)


def test_generate_tensor_truncation_and_bends(ckpt, wav, monkeypatch, tmp_path):
    def get_truncation(args):
        return torch.linspace(0.3, 1.0, args.n_frames)

    def get_bends(args):
        return [translate_bend(2, modulation=torch.linspace(0, 1, args.n_frames))]

    plain, trunc, bent = [], [], []
    run(ckpt, wav, plain, monkeypatch, tmp_path, "p.mp4")
    run(ckpt, wav, trunc, monkeypatch, tmp_path, "t.mp4", get_truncation=get_truncation)
    run(ckpt, wav, bent, monkeypatch, tmp_path, "b.mp4", get_bends=get_bends)
    assert len(plain) == len(trunc) == len(bent) == 3
    assert not np.array_equal(np.stack(plain), np.stack(trunc))
    assert not np.array_equal(np.stack(plain), np.stack(bent))


def test_generate_rewrites_leave_weights_untouched(ckpt, wav, monkeypatch, tmp_path):
    def perturb(weight, mod):
        return weight + mod.mean() * 0.5 * weight.std() * torch.sign(weight)

    def get_rewrites(args):
        return [Rewrite("conv1.conv.weight", perturb, modulation=torch.ones(args.n_frames))]

    plain, rewritten, plain2 = [], [], []
    run(ckpt, wav, plain, monkeypatch, tmp_path, "p.mp4", seed=3)
    run(ckpt, wav, rewritten, monkeypatch, tmp_path, "r.mp4", seed=3, get_rewrites=get_rewrites)
    run(ckpt, wav, plain2, monkeypatch, tmp_path, "p2.mp4", seed=3)
    assert not np.array_equal(np.stack(plain), np.stack(rewritten))
    np.testing.assert_array_equal(np.stack(plain), np.stack(plain2))


def test_cli_plugin_and_override(ckpt, wav, monkeypatch, tmp_path):
    plugin = tmp_path / "plug.py"
    plugin.write_text(
        "import torch\n"
        "OVERRIDE = dict(fps=2, duration=1.0)\n"
        "def get_truncation(args):\n"
        "    return torch.linspace(0.5, 1.0, args.n_frames)\n"
    )
    funcs, override = tcli.load_plugin(str(plugin))
    assert override == {"fps": 2, "duration": 1.0}
    assert funcs["get_truncation"] is not None and funcs["get_latents"] is None
    frames = []
    monkeypatch.setattr(torch_frames, "VideoWriter", sink(frames))
    argv = ["--ckpt", ckpt, "--audio_file", wav, "--audioreactive_file", str(plugin), "--G_res", "32", "--out_size", "32",
            "--fps", "8", "--batch", "2", "--latent_count", "8", "--output_dir", str(tmp_path / "out"), "--device", "cpu"]
    assert tcli.main(argv) == 0
    assert len(frames) == 2  # OVERRIDE: 1 s at 2 fps
    assert tcli.build_parser().parse_args(argv).device == "cpu"


def test_generate_without_a_card_needs_cpu(ckpt, wav, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.generate(ckpt, wav, output_file=str(tmp_path / "x.mp4"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--ckpt", ckpt, "--audio_file", wav, "--output_dir", str(tmp_path / "o")])


def test_generate_refuses_stylegan1_and_mesh(ckpt, wav):
    """stylegan1=True runs (tests/test_torch_port_stylegan1.py) but refuses a
    StyleGAN2 checkpoint; mesh= runs (tests/test_torch_port_parallel.py) but
    refuses a mesh that does not start with the render device."""
    with pytest.raises(ValueError, match="StyleGAN1"):
        tpipe.generate(ckpt, wav, stylegan1=True, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        tpipe.generate(ckpt, wav, mesh=["meta", "cpu"], device="cpu")

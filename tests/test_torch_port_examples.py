"""The port's example plugins (maua_tpu_torch/examples/tauceti.py, kelp.py,
temper.py, rewrite_demo.py),
loaded through the port's CLI plugin loader and run on a 2 s WAV on the CPU
beside the JAX package's examples/ through its loader: the same functions,
the same OVERRIDE, outputs of the same shapes; the bends' deterministic parts
(the scroll timeline, the pad) agree at 1e-5. The port's tauceti clamps its
drop to the track, where the JAX example fails on tracks under 45 s."""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maua_tpu.audio as jar
import maua_tpu_torch.audio as tar
from maua_tpu.pipeline.cli import load_plugin as jax_load_plugin
from maua_tpu_torch.pipeline.cli import PLUGIN_FUNCS, load_plugin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR, DUR, FPS = 22050, 2.0, 12


@pytest.fixture(autouse=True)
def cpu():
    smf_j, smf_t = jar.get_SMF(), tar.get_SMF()
    tar.set_device("cpu")
    yield
    jar.set_SMF(smf_j)
    tar.set_SMF(smf_t)
    tar.set_device(None)


def args_pair():
    n = int(SR * DUR)
    y = 0.1 * np.sin(2 * np.pi * 440.0 * np.arange(n) / SR)
    for s in range(SR // 8, n - 100, SR // 4):
        y[s : s + 100] += np.hanning(100)
    y = (y + 0.003 * np.random.default_rng(0).standard_normal(n)).astype(np.float32)

    return tuple(argparse.Namespace(audio=audio, sr=SR, duration=DUR, fps=FPS, n_frames=int(DUR * FPS))
                 for audio in (y, torch.from_numpy(y)))


@pytest.mark.parametrize("name,noise_sizes", [
    ("tauceti", [(4, 8), (8, 16), (64, 128), (256, 512)]),
    ("kelp", [(4, 4), (8, 8), (32, 32), (1024, 1024)]),
    ("temper", [(4, 4), (32, 32), (64, 64), (512, 512)]),
    ("rewrite_demo", []),
])
def test_example_plugin_matches_jax_shapes(name, noise_sizes):
    funcs, override = load_plugin(os.path.join(REPO, "maua_tpu_torch", "examples", f"{name}.py"))
    jfuncs, joverride = jax_load_plugin(os.path.join(REPO, "examples", f"{name}.py"))
    assert override == joverride
    assert [k for k in PLUGIN_FUNCS if funcs[k] is not None] == [k for k in PLUGIN_FUNCS if jfuncs[k] is not None]

    ja, ta = args_pair()
    jfuncs["initialize"](ja)
    funcs["initialize"](ta)
    for key in vars(ja):
        want = getattr(ja, key)
        if key != "audio" and hasattr(want, "shape"):
            got = getattr(ta, key)
            assert isinstance(got, torch.Tensor) and tuple(got.shape) == tuple(want.shape), key

    sel = 0.5 * np.random.default_rng(1).standard_normal((12, 6, 16)).astype(np.float32)
    got = funcs["get_latents"](torch.from_numpy(sel), ta)
    want = jfuncs["get_latents"](jnp.asarray(sel), ja)
    n_latent = 18 if name == "rewrite_demo" else 6  # slerp_loops gives its default 18 rows
    assert tuple(got.shape) == tuple(want.shape) == (ta.n_frames, n_latent, 16)
    assert bool(torch.isfinite(got).all())

    for h, w in noise_sizes:
        got, want = funcs["get_noise"](h, w, 0, 9, ta), jfuncs["get_noise"](h, w, 0, 9, ja)
        assert (got is None) == (want is None)
        if got is not None:
            assert tuple(got.shape) == tuple(want.shape) == (ta.n_frames, 1, h, w)
            assert float(torch.std(got, correction=0)) == pytest.approx(float(jnp.std(want)), rel=1e-4)

    if funcs["get_bends"] is not None:
        short = funcs["get_bends"](ta)  # the JAX example's drop indexing fails below 45 s; the port's clamps
        assert float(short[2].modulation.abs().max()) == 0.0 and len(short[2].modulation) == ta.n_frames
        ja.duration = ta.duration = 150.0  # the drop, 45 s to 135 s, falls inside the timeline
        bends, jbends = funcs["get_bends"](ta), jfuncs["get_bends"](ja)
        assert [b.layer for b in bends] == [b.layer for b in jbends]
        x = np.random.default_rng(2).standard_normal((2, 3, 4, 4)).astype(np.float32)
        pad, jpad = bends[0].transform(torch.from_numpy(x), None), jbends[0].transform(jnp.asarray(x), None)
        np.testing.assert_array_equal(pad.numpy(), np.asarray(jpad))
        assert tuple(bends[1].transform(pad, None).shape) == tuple(jbends[1].transform(jpad, None).shape) == (2, 3, 4, 8)
        np.testing.assert_allclose(bends[2].modulation.numpy(), np.asarray(jbends[2].modulation), atol=1e-5)


def jax_normal(key, shape):
    return torch.from_numpy(np.array(jax.random.normal(key, shape)))


def test_temper_matches_jax_given_its_draws(monkeypatch):
    """temper's get_latents and get_noise against the JAX example's, on the
    JAX example's onset envelopes and, for the noise, its jax.random draws
    (PRNGKey(hash((h, w))) split in two): latents within 1e-5 of the largest,
    noise within 1e-4 of the largest (the sigma = 128 filter sums 1,000
    taps), circular_mask equal."""
    funcs, _ = load_plugin(os.path.join(REPO, "maua_tpu_torch", "examples", "temper.py"))
    jfuncs, _ = jax_load_plugin(os.path.join(REPO, "examples", "temper.py"))
    module, jmodule = funcs["get_noise"].__globals__, jfuncs["get_noise"].__globals__  # both loaded as one name
    np.testing.assert_array_equal(module["circular_mask"](12, 16, soft=2),
                                  np.asarray(jmodule["circular_mask"](12, 16, soft=2)))

    ja, ta = args_pair()
    jfuncs["initialize"](ja)
    ta.lo_onsets, ta.hi_onsets = (torch.from_numpy(np.array(getattr(ja, k))) for k in ("lo_onsets", "hi_onsets"))

    sel = 0.5 * np.random.default_rng(1).standard_normal((12, 6, 16)).astype(np.float32)
    got = funcs["get_latents"](torch.from_numpy(sel), ta).numpy()
    want = np.asarray(jfuncs["get_latents"](jnp.asarray(sel), ja))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())

    def draws(n_frames, height, width, device):
        k1, k2 = jax.random.split(jax.random.PRNGKey(hash((height, width)) % 2**31))
        return tuple(jax_normal(k, (n_frames, 1, height, width)) for k in (k1, k2))

    monkeypatch.setitem(module, "draw_noise", draws)
    for h, w in [(4, 4), (32, 32), (64, 64), (256, 256)]:
        got, want = funcs["get_noise"](h, w, 0, 9, ta).numpy(), np.asarray(jfuncs["get_noise"](h, w, 0, 9, ja))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(), err_msg=f"{h}x{w}")


def test_rewrite_demo_matches_jax_given_its_draw(monkeypatch):
    """rewrite_demo's get_latents and its rewrite of conv1's weight against
    the JAX example's (Rewrite("conv1/conv/weight") on [O, I, 3, 3]; the
    port's dotted key on [1, O, I, 3, 3]), with the JAX example's
    PRNGKey(42) direction: within 1e-6 of the largest value."""
    funcs, _ = load_plugin(os.path.join(REPO, "maua_tpu_torch", "examples", "rewrite_demo.py"))
    jfuncs, _ = jax_load_plugin(os.path.join(REPO, "examples", "rewrite_demo.py"))
    monkeypatch.setitem(funcs["get_rewrites"].__globals__, "draw_direction",
                        lambda shape, dtype, device: jax_normal(jax.random.PRNGKey(42), tuple(shape)[1:]).reshape(shape))

    ja, ta = args_pair()
    jfuncs["initialize"](ja)
    ta.kick_onsets = torch.from_numpy(np.array(ja.kick_onsets))
    ja.duration = ta.duration = 20.0  # two loops
    sel = 0.5 * np.random.default_rng(1).standard_normal((4, 6, 16)).astype(np.float32)
    got = funcs["get_latents"](torch.from_numpy(sel), ta).numpy()
    want = np.asarray(jfuncs["get_latents"](jnp.asarray(sel), ja))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())

    (rw,), (jrw,) = funcs["get_rewrites"](ta), jfuncs["get_rewrites"](ja)
    assert (rw.param_path, jrw.param_path) == ("conv1.conv.weight", "conv1/conv/weight")
    np.testing.assert_allclose(rw.modulation.numpy(), np.asarray(jrw.modulation), atol=0)
    w = np.random.default_rng(3).standard_normal((8, 6, 3, 3)).astype(np.float32)
    mod = np.array(ja.kick_onsets[:4])
    got = rw.transform(torch.from_numpy(w)[None], torch.from_numpy(mod))[0].numpy()
    want = np.asarray(jrw.transform(jnp.asarray(w), jnp.asarray(mod)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_rewrite_demo_runs_in_generate(tmp_path, monkeypatch):
    """generate() with rewrite_demo, which brings its own initialize but no
    get_noise: the default noise gets the default onset envelopes (the JAX
    package raises AttributeError there), and the rewrite moves conv1's
    weight on kicks only: 6 frames at 32^2 on the CPU."""
    import scipy.io.wavfile

    import maua_tpu_torch.render.frames as frames_mod
    from maua_tpu_torch.pipeline import generate
    from test_torch_port_parallel import _sink, small_generator

    monkeypatch.chdir(tmp_path)
    torch.save({"g_ema": small_generator().state_dict()}, tmp_path / "g.pt")
    y = args_pair()[0].audio
    scipy.io.wavfile.write(str(tmp_path / "a.wav"), SR, (y * 32767).astype(np.int16))
    funcs, _ = load_plugin(os.path.join(REPO, "maua_tpu_torch", "examples", "rewrite_demo.py"))
    frames = []
    monkeypatch.setattr(frames_mod, "VideoWriter", _sink(frames))
    generate(str(tmp_path / "g.pt"), str(tmp_path / "a.wav"), G_res=32, out_size=32, fps=4, duration=1.5, batch=3,
             latent_dim=64, n_mlp=2, output_file=str(tmp_path / "o.mp4"), device="cpu", **funcs)
    assert len(frames) == 6 and np.stack(frames).std() > 0

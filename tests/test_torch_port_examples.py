"""The port's example plugins (maua_tpu_torch/examples/tauceti.py, kelp.py),
loaded through the port's CLI plugin loader and run on a 2 s WAV on the CPU
beside the JAX package's examples/ through its loader: the same functions,
the same OVERRIDE, outputs of the same shapes; the bends' deterministic parts
(the scroll timeline, the pad) agree at 1e-5. The port's tauceti clamps its
drop to the track, where the JAX example fails on tracks under 45 s."""

import argparse
import os

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
    assert tuple(got.shape) == tuple(want.shape) == (ta.n_frames, 6, 16)
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

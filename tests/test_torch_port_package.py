"""maua_tpu_torch stands alone and fails loudly without a card: importing
every module (the training, data, audio, reactive, pipeline, eval, telemetry
and parallel subpackages, the VAE family, StyleGAN1, the TF-pickle reader and
the example plugins included) pulls in no jax,
flax or maua_tpu; the entry points raise RuntimeError when they would need
CUDA and there is none; chip_smoke.py fails without a card and outside the
repo."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from maua_tpu_torch.io import load_generator
from maua_tpu_torch.models import Generator
from maua_tpu_torch.render import render
from maua_tpu_torch.train import init_train_state, make_train_config
from maua_tpu_torch.train.cli import build_parser, train_loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORT_ALL = """
import importlib, pkgutil, sys
import maua_tpu_torch
names = [m.name for m in pkgutil.walk_packages(maua_tpu_torch.__path__, "maua_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "maua_tpu"))
print(len(names), ",".join(names), bad)
"""


def _clean_env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = REPO
    return env


def test_package_imports_no_jax_or_maua_tpu():
    out = subprocess.run(
        [sys.executable, "-c", IMPORT_ALL], cwd=REPO, env=_clean_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    n_modules, names, bad = out.stdout.strip().split(" ", 2)
    assert int(n_modules) >= 79
    for sub in ("train.step", "train.cli", "train.checkpoint", "train.augment", "train.fft_warp", "train.contrastive",
                "ops.gather", "data.prepare", "data.loader", "data.records", "data.synthetic",
                "audio.postprocess", "audio.dsp", "audio.hpss", "audio.onsets", "audio.chroma", "audio.features",
                "audio.io", "audio.segmentation", "audio.util", "reactive.latent", "reactive.noise", "reactive.bend",
                "pipeline.defaults", "pipeline.generate", "pipeline.cli", "examples.tauceti", "examples.kelp",
                "pipeline.sample", "pipeline.select_latents", "pipeline.interpolate", "pipeline.projector",
                "models.stylegan1", "io.tf_pkl", "ops.resize", "draws", "eval.lpips", "eval.inception",
                "eval.metrics", "eval.swd", "eval.cli", "telemetry", "telemetry.spectral", "telemetry.memory",
                "telemetry.monitor", "telemetry.profiling", "parallel", "parallel.mesh", "models.autoencoder",
                "train.vae", "train.vae_cli", "data.prepare_vae_codes", "examples.temper", "examples.rewrite_demo"):
        assert f"maua_tpu_torch.{sub}" in names.split(","), sub
    assert bad == "[]", f"maua_tpu_torch imported {bad}"


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device resolves")


def test_load_generator_without_device_needs_cuda(tmp_path):
    _no_cuda()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_generator(str(tmp_path / "missing.pt"))


def test_render_without_device_needs_cuda(tmp_path):
    _no_cuda()
    gen = Generator(size=8, style_dim=16, n_mlp=1, channel_max=16, constant_input=True)
    latents = np.zeros((2, gen.n_latent, 16), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        render(gen, None, latents, [], str(tmp_path / "x.mp4"))


def test_init_train_state_without_device_needs_cuda():
    _no_cuda()
    cfg = make_train_config(size=16, batch_size=4, channel_max=32, augment=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(cfg)


def test_train_loop_without_device_needs_cuda(tmp_path):
    _no_cuda()
    args = build_parser().parse_args(["--path", str(tmp_path), "--size", "16", "--no-augment", "--run_dir", str(tmp_path / "run")])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_loop(args)
    assert not (tmp_path / "run").exists()


def _run_smoke(cwd):
    env = _clean_env()
    if cwd != REPO:  # nothing of the repo on the path
        env["PYTHONPATH"] = ""
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env, capture_output=True, text=True, timeout=300
    )


def test_chip_smoke_fails_without_a_card():
    _no_cuda()
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    out = _run_smoke(str(tmp_path))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout

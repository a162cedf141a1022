"""The command line: it refuses to run without a card (no CPU fallback) and
in a checkout that holds only the benchmark, printing no result either way;
and nothing that portbench imports or runs has the top-level name of JAX or
the JAX package."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "maua_tpu"}


def _result_lines(stdout: str) -> list[str]:
    out = []
    for line in stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                out.append(line)
        except ValueError:
            pass
    return out


def _cli(cwd: Path, env=None) -> subprocess.CompletedProcess:
    cmd = [sys.executable, "-m", "portbench.run", "--workload", "ffhq1024.render", "--seed", "5", "--seconds", "1",
           "--trace", "0"]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal without one cannot be shown here")
    proc = _cli(ROOT)
    assert proc.returncode != 0
    assert not _result_lines(proc.stdout)
    assert "CUDA" in proc.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = _cli(tmp_path, env)
    assert proc.returncode != 0
    assert not _result_lines(proc.stdout)


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_a_run_loads_no_jax():
    """A tiny run of every driver in a fresh process leaves no module of JAX
    or the JAX package in sys.modules (whole top-level names)."""
    code = (
        "import sys, torch; torch.set_num_threads(2)\n"
        "from portbench.run import execute\n"
        "from portbench.common import forbidden_modules\n"
        "from portbench.tests.tiny import tiny\n"
        "for name in ('ffhq1024.render', 'sg2-256.train'):\n"
        "    execute(tiny(name), 7, 0.2, False, device='cpu')\n"
        "mods = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'maua_tpu_torch' in mods\n"
        "print('FOUND', forbidden_modules())\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-W", "ignore", "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "FOUND []" in proc.stdout

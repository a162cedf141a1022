"""The controls of `correct`, on a card at each cell's own size: the
reference put in the program's place in the next precision below the
configuration's (TF32 for fp32 with TF32 off) has to fail one of the cell's
limits, and so has the reference with half of every batch left out (the
training cells). Run on the card with

    python3 -m pytest portbench/tests/test_portbench_control.py -m cuda

The card is looked for inside each test; without one they skip."""

from __future__ import annotations

import pytest

from portbench.calibrate import reading
from portbench.common import benchmark, find_cell
from portbench.run import limits

CELLS = [w["name"] for w in benchmark()["workloads"]]


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the controls run at the cells' own sizes")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_tf32_control_fails(name):
    _card()
    r = reading(find_cell(name), 1_000_003, "control")
    lim = limits(name)
    assert any(r[k] > v for k, v in lim.items()), r


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c for c in CELLS if find_cell(c).traffic["driver"] == "train"])
def test_half_batch_fails(name):
    _card()
    r = reading(find_cell(name), 1_000_033, "half_batch")
    lim = limits(name)
    assert any(r[k] > v for k, v in lim.items()), r

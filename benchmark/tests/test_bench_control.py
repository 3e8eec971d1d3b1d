"""On the card: the control (the reference in TF32, the precision below the
configurations' float32, put in the program's place) fails each cell's
check, at the cell's widths on fewer requests than a run compares. Run
there with ``python -m pytest benchmark/tests -q -m cuda``; each case skips
without a card."""

import tempfile

import pytest
import torch

from benchmark.lib import harness, port
from benchmark.lib.registry import Registry
from benchmark.lib.weights import seeded_state

REG = Registry()
CELLS = [w["name"] for w in REG.spec["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_check(cell, card):
    w = REG.cell(cell)
    config, traffic = REG.config(w["config"]), REG.traffic(w["traffic"])
    limits = REG.limits(cell)
    with tempfile.TemporaryDirectory() as scratch:
        loop = harness.make_loop(REG, config, dict(traffic, check_requests=2), 2**31 + 5, card,
                                 scratch)
        if traffic["loop"] == "serve":
            loop.state = seeded_state(port.template(config), 2**31 + 5, card)
            readings = loop.control(traffic["cycle"])
        else:
            loop.setup(False)
            loop.free()
            readings = loop.control()
    assert any(readings[k] > lim for k, lim in limits.items()), readings

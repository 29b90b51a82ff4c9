"""On the card: the control, the reference in float8 in the program's
place, comes out not correct at each cell's own size and limits.

    python -m pytest benchmark/tests/test_control_on_card.py -q

Skips without a CUDA card (decided inside the test)."""

from __future__ import annotations

import json

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_float8_control_fails(cell, bench, card):
    out = harness.run_cell(bench, cell, 3000000301, 1.0, False, card, 0.0,
                           ROOT, mode="control")
    assert not out["correct"], out["checks"]

"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
root of the repository.  The tiny cells of ``data/bench.json`` run on the
CPU in float32; tests marked ``cuda`` run on the card and skip without
one."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def tiny_bench():
    return json.loads((DATA / "bench.json").read_text())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")

"""What the benchmark loads, and what it refuses to run."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

from benchmark import harness
from benchmark.tests.conftest import ROOT

JAX_SIDE = {"jax", "jaxlib", "flax", "rtsds_tpu"}


def imported_top_levels(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_the_jax_side():
    for path in harness.HERE.rglob("*.py"):
        assert not imported_top_levels(path) & JAX_SIDE, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.HERE / "reference").rglob("*.py"):
        assert "rtsds_tpu_torch" not in imported_top_levels(path), path


def test_a_run_loads_no_jax_module():
    code = (
        "import json, sys; sys.path.insert(0, sys.argv[1]);"
        "from pathlib import Path; from benchmark import harness;"
        "from benchmark.tests.conftest import DATA;"
        "root = Path(sys.argv[1]);"
        "bench = json.loads((DATA / 'bench.json').read_text());"
        "harness.run_cell(bench, 'tiny_deeplabv2_r101.da_v1', 3, 0.3, False,"
        " 'cpu', 0.0, root, (DATA, harness.HERE));"
        "harness.run_cell(bench, 'tiny_bisenet_r18.stream', 3, 0.3, False,"
        " 'cpu', 0.0, root, (DATA, harness.HERE));"
        "print(json.dumps(harness.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rtsds_tpu_torch_like", sys)
    assert "rtsds_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert "flax" in harness.forbidden_modules()


def run_py(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "deeplabv2_r101.stream_b8", "--seed", "2147483999", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                              PYTHONPATH="", **(env or {})))


def test_without_a_card_it_exits_non_zero_and_prints_no_result():
    out = run_py(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_it_exits_non_zero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = run_py(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""

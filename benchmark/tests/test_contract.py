"""BENCHMARK.json against the benchmark's contract, and every file a cell
needs found by name."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import harness
from benchmark.tests.conftest import DATA, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)


def test_command_and_paths(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(bench["command"]) <= 32
    for word in bench["command"]:
        assert one_line(word) and not word.startswith("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in bench["paths"])


def test_names_units_and_entry_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/")
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert one_line(w["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert one_line(m["layer"])
    all_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(all_names) == len(set(all_names))
    cells = [w["name"] for w in bench["workloads"]]
    assert len(cells) == len(set(cells))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        reported = {m["name"] for m in harness.metrics_of_e2e(bench,
                                                              w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        layer = harness.metrics_of(bench, "per_layer", w["name"])
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in reported, (m["name"], w["name"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e


def test_rooflines_and_mfu_are_named_by_the_rule(bench):
    for m in bench["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    moved = {m["moves"] for m in bench["per_layer"]
             if m["name"].endswith("_roofline")}
    for e in moved:
        assert any("mfu" in m["name"] and m["moves"] == e
                   for m in bench["per_layer"])


@pytest.mark.parametrize("which", ["real", "tiny"])
def test_every_cell_finds_its_files_by_name(which, bench, tiny_bench):
    b = bench if which == "real" else tiny_bench
    dirs = (harness.HERE,) if which == "real" else (DATA, harness.HERE)
    for w in b["workloads"]:
        cell = harness.make_cell(b, w["name"], 1, 1.0, False, "cpu", ROOT,
                                 dirs)
        assert harness.find(dirs, "drivers",
                            f"{cell.traffic['kind']}.py").is_file()
        limits = harness.limits_of(cell, dirs)
        assert limits and all(v >= 0 for v in limits.values())
        for m in harness.metrics_of(b, "per_layer", w["name"]):
            assert harness.find(dirs, "layer_metrics", f"{m['name']}.py")
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]


def test_file_names_keep_to_the_name_characters():
    for path in harness.HERE.rglob("*"):
        if "__pycache__" in path.parts or ".cache" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel


def test_the_run_budget_fits_twenty_four_cells(bench):
    runs = 2 + 14 * 24
    total = runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200

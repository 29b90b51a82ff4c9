"""Runs one cell of ``BENCHMARK.json`` and assembles the result's line.

Everything that belongs to one cell is found by name, in the first of
``dirs`` (default: this directory) that has it:

* ``configs``: the entry's ``file``, a JSON of the model's sizes;
* ``traffic/<traffic>.json``: the mix, whose ``kind`` names the driver;
* ``drivers/<kind>.py``: ``run(cell) -> Outcome``;
* ``layer_metrics/<metric>.py``: ``read(run) -> float | None``;
* ``limits/<workload>.json``: the limit of each number the driver
  compares with the reference.

A new configuration, mix or per-layer metric is new files and a new entry
of ``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rtsds_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    mode: str = "program"  # or "control", or a planted fault's name
    # (name, time.perf_counter()) at the end of each step of set-up
    marks: list = dataclasses.field(default_factory=list)
    # hostload.snapshot() at the process's start, if taken
    host_start: dict | None = None

    def mark(self, name: str) -> None:
        self.marks.append((name, time.perf_counter()))


@dataclasses.dataclass
class Outcome:
    """What a driver hands back.  ``checks`` maps each compared number to
    its value; ``metrics`` are the end-to-end numbers; ``counters`` and
    ``trace`` feed the per-layer readers."""
    attempted: int
    failed: int
    window_start: float
    metrics: dict
    checks: dict
    counters: dict
    memory_peak_bytes: int = 0
    trace: object = None


@dataclasses.dataclass
class Run:
    """What a per-layer reader sees."""
    cell: Cell
    counters: dict
    trace: object
    card: str


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find(dirs, *parts) -> Path:
    for d in dirs:
        path = Path(d).joinpath(*parts)
        if path.is_file():
            return path
    raise FileNotFoundError(f"{'/'.join(parts)} is in none of {list(dirs)}")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(bench: dict, name: str, root: Path) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, key: str, cell: str) -> list[dict]:
    """The entries of ``bench[key]`` that ``cell`` reports: those that list
    it, or, without a list, those whose end-to-end metric it reports."""
    e2e = {m["name"] for m in metrics_of_e2e(bench, cell)}
    out = []
    for m in bench[key]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif key == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def metrics_of_e2e(bench: dict, cell: str) -> list[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def make_cell(bench: dict, name: str, seed: int, seconds: float,
              trace: bool, device, root: Path, dirs,
              mode: str = "program") -> Cell:
    w = workload(bench, name)
    traffic = json.loads(find(dirs, "traffic", f"{w['traffic']}.json")
                         .read_text())
    return Cell(name, config_of(bench, w["config"], root), traffic, seed,
                seconds, trace, device, mode)


def drive(cell: Cell, dirs) -> Outcome:
    kind = cell.traffic["kind"]
    driver = load_module(find(dirs, "drivers", f"{kind}.py"),
                         f"benchmark_driver_{kind}")
    return driver.run(cell)


def limits_of(cell: Cell, dirs) -> dict:
    return json.loads(find(dirs, "limits", f"{cell.name}.json").read_text())


def judged(checks: dict, limits: dict) -> tuple[bool, dict]:
    """Each number that the cell's limits name, beside its limit; correct
    when none exceeds it or is missing.  A number the limits do not name
    is not compared in this cell."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = checks.get(name)
        ok &= value is not None and value == value and value <= limit
        out[name] = {"value": value, "limit": limit}
    return ok, out


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def device_info(device, memory_peak_bytes: int) -> dict:
    import torch

    cuda = torch.device(device).type == "cuda"
    return {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": 1, "memory_peak_bytes": int(memory_peak_bytes),
            "name_and_power_limit": power_limit() if cuda else None}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def setup_steps(start: float, marks, window_start: float) -> dict:
    """Seconds from each mark to the next, from the process's start to
    the window's."""
    out, at = {}, start
    for name, t in list(marks) + [("to_window", window_start)]:
        out[name] = round(t - at, 3)
        at = t
    return out


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             trace: bool, device, process_start: float, root: Path,
             dirs=(HERE,), mode: str = "program", marks=(),
             host_start: dict | None = None) -> dict:
    """One run of cell ``name``: the contract's result as a dict, with the
    driver's ``counters`` (sample counts, what the host gave; not part of
    the line), the seconds of each step of set-up (``setup_steps``) and
    the ``checks`` last.  ``marks`` are the steps of set-up already
    taken, as ``Cell.marks``."""
    cell = make_cell(bench, name, seed, seconds, trace, device, root, dirs,
                     mode)
    cell.marks[:0] = list(marks)
    cell.host_start = host_start
    limits = limits_of(cell, dirs)
    outcome = drive(cell, dirs)
    gc.collect()
    correct, checks = judged(outcome.checks, limits)
    correct &= outcome.failed == 0
    if trace and device_info(device, 0)["platform"] == "gpu" and not (
            outcome.trace.busy_s > 0):
        raise RuntimeError("the profiler recorded no device activity")
    if mode != "program":
        metrics = {}
    elif trace:
        card = device_info(device, 0)["kind"]
        run = Run(cell, outcome.counters, outcome.trace, card)
        metrics = {}
        for m in metrics_of(bench, "per_layer", name):
            reader = load_module(find(dirs, "layer_metrics",
                                      f"{m['name']}.py"),
                                 f"benchmark_metric_{len(metrics)}")
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        measured = dict(outcome.metrics,
                        setup_s=outcome.window_start - process_start)
        metrics = {m["name"]: {"value": float(measured[m["name"]]),
                               "unit": m["unit"]}
                   for m in metrics_of_e2e(bench, name)}
    result = {"correct": bool(correct), "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics,
              "device": device_info(device, outcome.memory_peak_bytes)}
    if trace and mode == "program":
        result["device"]["busy_s"] = outcome.trace.busy_s
        result["device"]["window_s"] = outcome.trace.window_s
        result["breakdown"] = outcome.trace.breakdown()
    result["counters"] = {k: v for k, v in outcome.counters.items()
                          if isinstance(v, (int, float, dict))}
    result["setup_steps"] = setup_steps(process_start, cell.marks,
                                        outcome.window_start)
    result["checks"] = checks
    return result

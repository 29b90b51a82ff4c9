"""Readings for the limits: the numbers a cell compares, over many seeds
of the program and of the control (the reference in float8), and, for a
training cell, of the planted half-batch fault, all in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds ...] [--fault-seeds ...] [--seconds 2]

prints one JSON line a run: its mode, seed, the compared numbers, and the
end-to-end metrics of the program's runs (short windows: not the cell's
figures).  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() != ROOT / "benchmark"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    runs = ([("program", s) for s in args.seeds]
            + [("control", s) for s in args.control_seeds]
            + [("half_batch", s) for s in args.fault_seeds])
    for mode, seed in runs:
        t = time.perf_counter()
        cell = harness.make_cell(bench, args.workload, seed, args.seconds,
                                 False, torch.device("cuda"), ROOT,
                                 (harness.HERE,), mode)
        outcome = harness.drive(cell, (harness.HERE,))
        print(json.dumps({
            "workload": args.workload, "mode": mode, "seed": seed,
            "checks": outcome.checks, "metrics": outcome.metrics,
            "worst": outcome.counters.get("worst_leaves"),
            "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

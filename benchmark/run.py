"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic, driver,
limits and per-layer readers are found by name (``harness.py``).  With
``--trace 0`` the last line of standard output is the contract's JSON with
the cell's end-to-end metrics; with ``--trace 1`` the window runs under
``torch.profiler`` and the line carries the per-layer metrics instead.  The
numbers compared with the reference, each beside its limit, are the last
lines of standard error and the line's last key.

Without a CUDA card the run exits 2 and prints no result.  Kernel caches
stay inside the checkout, at fixed paths.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def process_start() -> float:
    """The process's start on ``time.perf_counter``'s clock (Linux:
    /proc/self/stat), else now."""
    now = time.perf_counter()
    try:
        ticks = int(Path("/proc/self/stat").read_text()
                    .rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - (uptime - ticks / os.sysconf("SC_CLK_TCK"))


START = process_start()
ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "benchmark" / ".cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() != ROOT / "benchmark"]


def main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark import hostload

    host_start = hostload.snapshot()
    import torch

    from benchmark import harness

    marks = [("imports", time.perf_counter())]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = harness.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")
    marks.append(("cuda_context", time.perf_counter()))
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda"), START,
                              ROOT, marks=marks, host_start=host_start)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the PyTorch "
              f"port alone", file=sys.stderr)
        return 3
    print(f"setup_steps {json.dumps(result.pop('setup_steps'))}",
          file=sys.stderr)
    print(f"counters {json.dumps(result.pop('counters'))}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What the host gave this process over a stretch of a run, from Linux's
own accounting (read only): CPU seconds in user and kernel mode, page
faults, context switches the process gave up and ones it was made to give
up, seconds its threads waited for a core (``/proc/self/schedstat``),
the machine's stolen seconds (``/proc/stat``), and the anonymous memory
held in huge pages at the end.  The drivers print the differences beside
their counters, so that a run that reads slow can be told apart: by the
work it did, or by the host it ran on."""

from __future__ import annotations

import os
import resource
import time
from pathlib import Path


def _read(path: str) -> str:
    try:
        return Path(path).read_text()
    except OSError:
        return ""


def _waited_s() -> float:
    """Seconds the process's threads spent runnable but waiting."""
    total = 0
    for tid in os.listdir("/proc/self/task") if os.path.isdir(
            "/proc/self/task") else ():
        parts = _read(f"/proc/self/task/{tid}/schedstat").split()
        if len(parts) >= 2:
            total += int(parts[1])
    return total / 1e9


def _steal_s() -> float:
    line = _read("/proc/stat").splitlines()[:1]
    parts = line[0].split() if line else []
    if len(parts) < 9:
        return 0.0
    return int(parts[8]) / os.sysconf("SC_CLK_TCK")


def _huge_mb() -> float:
    for line in _read("/proc/self/smaps_rollup").splitlines():
        if line.startswith("AnonHugePages:"):
            return int(line.split()[1]) / 1024
    return 0.0


def snapshot() -> dict:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return {"wall_s": time.perf_counter(), "user_s": r.ru_utime,
            "sys_s": r.ru_stime, "minor_faults": r.ru_minflt,
            "major_faults": r.ru_majflt, "yielded": r.ru_nvcsw,
            "preempted": r.ru_nivcsw, "waited_s": _waited_s(),
            "steal_s": _steal_s()}


def since(before: dict, now: dict | None = None) -> dict:
    """What changed from ``before`` to ``now`` (default: now), rounded for
    reading, with the huge pages held now."""
    now = now or snapshot()
    out = {k: round(now[k] - before[k], 4) for k in before}
    out["huge_mb"] = round(_huge_mb(), 1)
    return out


def counters(host_start: dict | None, window) -> dict:
    """What the host gave the process over the window (``window``, the
    holder of ``trace.profiled``) and, with the process's first snapshot,
    over set-up."""
    out = {"window_host": window.host}
    if host_start is not None:
        out["setup_host"] = since(host_start, window.host_before)
    return out

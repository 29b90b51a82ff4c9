"""Tracing: a ``torch.profiler`` trace of a block, and named regions in it.

Counterpart of ``rtsds_tpu/utils/profiling.py``:

  * :func:`trace` records the enclosed block (host and, where a GPU is
    present, device activity) and writes a Chrome/Perfetto trace file
    into ``log_dir`` (open it in ui.perfetto.dev or chrome://tracing);
  * :func:`annotate` marks a named region, which shows in the trace.

FLOPs are counted by ``rtsds_tpu_torch/bench/flops.py``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block; on exit write
    ``<log_dir>/rtsds_<pid>_<ns>.pt.trace.json``.  Yields the profiler, whose
    ``key_averages()`` sums time by operator."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"rtsds_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def annotate(name: str):
    """Named region: ``with annotate("step"): ...``."""
    return record_function(name)

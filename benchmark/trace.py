"""The traced run: ``torch.profiler`` over the measured window, reduced in
memory to what the per-layer readers need.

Device activity is every event the profiler records on the CUDA device:
kernels, memory copies and memsets (not the device's mirror of a
``record_function`` range).  ``busy_s`` is the length of the union
of their intervals, ``window_s`` the traced window's.  The benchmark's own
``record_function`` spans (names starting ``bench.``) say what the host
was doing; a kernel belongs to the span in which the host launched it (the
launch's runtime call, matched by correlation id), and an idle gap of the
device to the innermost span open at the gap's start.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses

import torch

from benchmark import hostload

SPAN_PREFIX = "bench."


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    # kernel name -> (launches, device seconds)
    kernels: dict
    # "HtoD" / "DtoH" / other copy kind -> (copies, device seconds)
    copies: dict
    # span name -> device seconds of the kernels launched inside it
    span_kernel_s: dict
    # span name -> (idle gaps that began inside it, idle seconds)
    idle_by_span: dict
    events: int

    def kernel_s(self, match) -> tuple[int, float]:
        """Launches and device seconds of the kernels whose name contains
        ``match``."""
        n, s = 0, 0.0
        for name, (k, t) in self.kernels.items():
            if match in name:
                n += k
                s += t
        return n, s

    def breakdown(self) -> dict:
        ops = collections.Counter()
        for name, (_, s) in self.kernels.items():
            ops[name[:120]] += s
        for kind, (_, s) in self.copies.items():
            ops[f"Memcpy {kind}"] += s
        gaps = sorted(((f"{name} ({n} gaps)", s) for name, (n, s)
                       in self.idle_by_span.items()), key=lambda x: -x[1])
        return {"device_ops": [[k, v] for k, v in ops.most_common(10)],
                "idle_gaps": [[k, v] for k, v in gaps[:10]]}


@contextlib.contextmanager
def profiled(enabled: bool):
    """Yields a holder whose ``trace`` is set once the block has ended
    (None when ``enabled`` is false), as is ``host``, what the host gave
    the process over the block (``hostload.since``); ``host_before`` is
    the snapshot taken as the block began."""
    holder = type("Holder", (), {"trace": None, "host": None})()
    holder.host_before = hostload.snapshot()
    if not enabled:
        yield holder
        holder.host = hostload.since(holder.host_before)
        return
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        yield holder
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
    holder.host = hostload.since(holder.host_before)
    holder.trace = reduce(prof.profiler.kineto_results.events())


def _is_device(ev) -> bool:
    return "CUDA" in str(ev.device_type())


def _copy_kind(name: str) -> str:
    for kind in ("HtoD", "DtoH", "DtoD", "HtoH", "PtoP"):
        if kind in name:
            return kind
    return name


def _is_annotation(ev) -> bool:
    """A ``record_function`` range (the benchmark's, or the program's such
    as ``Optimizer.step#Adam.step``), on the host or mirrored on the
    device."""
    flag = getattr(ev, "is_user_annotation", None)
    return bool(flag()) if flag is not None else \
        ev.name().startswith(SPAN_PREFIX)


def _is_launch(name: str) -> bool:
    """A runtime or driver call that puts work on the device."""
    return name.startswith(("cuda", "cu")) and any(
        w in name for w in ("Launch", "Memcpy", "Memset"))


def reduce(events) -> Trace:
    device, spans, launches = [], [], {}
    for ev in events:
        start, dur = ev.start_ns(), ev.duration_ns()
        name = ev.name()
        if _is_annotation(ev):
            # a span, and on the device its mirror, which is no device work
            if name.startswith(SPAN_PREFIX) and not _is_device(ev):
                spans.append((start, start + dur, name))
        elif _is_device(ev):
            device.append((start, start + dur, name, ev.correlation_id()))
        elif _is_launch(name):
            launches[ev.correlation_id()] = start
    device.sort()
    spans.sort()
    bounds = [e[0] for e in device] + [s[0] for s in spans]
    if not bounds:
        raise RuntimeError("the profiler recorded neither spans nor device "
                           "activity")
    t0 = min(bounds)
    t1 = max([e[1] for e in device] + [s[1] for s in spans])
    kernels, copies = {}, {}
    busy, gaps = 0, []
    cur_s, cur_e = (device[0][0], device[0][1]) if device else (t0, t0)
    for s, e, name, _ in device:
        if name.startswith("Memcpy"):
            n, t = copies.get(_copy_kind(name), (0, 0.0))
            copies[_copy_kind(name)] = (n + 1, t + (e - s) / 1e9)
        else:
            n, t = kernels.get(name, (0, 0.0))
            kernels[name] = (n + 1, t + (e - s) / 1e9)
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if device and device[0][0] > t0:
        gaps.insert(0, (t0, device[0][0]))
    if cur_e < t1:
        gaps.append((cur_e, t1))

    starts = [s[0] for s in spans]

    def innermost(t: int) -> str:
        """The latest-started span that is open at ``t`` (spans nest a
        few deep, so the look goes back a few spans only)."""
        i = bisect.bisect_right(starts, t) - 1
        stop = max(i - 16, -1)
        while i > stop:
            s, e, name = spans[i]
            if e >= t:
                return name
            i -= 1
        return "outside the spans"

    idle = {}
    for s, e in gaps:
        name = innermost(s)
        n, t = idle.get(name, (0, 0.0))
        idle[name] = (n + 1, t + (e - s) / 1e9)
    span_kernel_s = collections.Counter()
    for s, e, name, corr in device:
        launched = launches.get(corr)
        if launched is not None:
            span_kernel_s[innermost(launched)] += (e - s) / 1e9
    return Trace(window_s=(t1 - t0) / 1e9, busy_s=busy / 1e9,
                 kernels=kernels, copies=copies,
                 span_kernel_s=dict(span_kernel_s), idle_by_span=idle,
                 events=len(device) + len(spans))

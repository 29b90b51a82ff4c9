"""The arithmetic of the metrics: the tail, the rate over the whole
window, the trace's reduction and the per-layer readers."""

from __future__ import annotations

import json

import pytest

from benchmark import flops, harness, stats, trace
from benchmark.tests.conftest import DATA, ROOT


class Ev:
    def __init__(self, name, start, dur, device="CPU", corr=0):
        self._n, self._s, self._d = name, start, dur
        self._dev, self._c = device, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return f"DeviceType.{self._dev}"

    def correlation_id(self):
        return self._c

    def is_user_annotation(self):
        return self._n.startswith(("bench.", "Optimizer."))


def test_percentile_is_nearest_rank():
    values = list(range(1, 101))
    assert stats.percentile(values, 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3, 1, 2], 95) == 3
    assert stats.percentile(list(range(1, 21)), 95) == 19


def synthetic():
    ms = 1_000_000
    return [
        Ev("bench.step", 0, 10 * ms),
        Ev("bench.transform", 1 * ms, 2 * ms),
        Ev("cudaLaunchKernel", int(1.5 * ms), 1000, corr=7),
        Ev("cudaLaunchKernel", 4 * ms, 1000, corr=8),
        Ev("remap_kernel", 2 * ms, 1 * ms, "CUDA", 7),
        Ev("gemm", 5 * ms, 2 * ms, "CUDA", 8),
        Ev("Memcpy HtoD (Pageable -> Device)", 6 * ms, 2 * ms, "CUDA", 9),
        Ev("bench.step", 0, 10 * ms, "CUDA"),  # the device's mirror
        Ev("Optimizer.step#Adam.step", 8 * ms, 2 * ms, "CUDA"),
        Ev("bench.metrics_read", 10 * ms, 2 * ms),
    ]


def test_trace_reduction_counts_busy_idle_and_launch_spans():
    t = trace.reduce(synthetic())
    assert t.window_s == pytest.approx(0.012)
    # device busy: [2, 3] and [5, 8] ms
    assert t.busy_s == pytest.approx(0.004)
    assert t.kernels["remap_kernel"] == (1, pytest.approx(0.001))
    assert t.copies["HtoD"] == (1, pytest.approx(0.002))
    assert t.span_kernel_s["bench.transform"] == pytest.approx(0.001)
    assert t.span_kernel_s["bench.step"] == pytest.approx(0.002)
    # gaps, each named by the span open at its start: [0, 2] in the
    # transform, [3, 5] and [8, 12] in the step
    assert t.idle_by_span["bench.transform"] == (1, pytest.approx(0.002))
    assert t.idle_by_span["bench.step"] == (2, pytest.approx(0.006))
    assert "bench.metrics_read" not in t.idle_by_span
    b = t.breakdown()
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert b["device_ops"][0][0] in ("gemm", "Memcpy HtoD")


def run_of(counters, t, config=None, card="NVIDIA H100 80GB HBM3"):
    cell = harness.Cell("c", config or {}, {}, 0, 1.0, True, "cuda")
    return harness.Run(cell, counters, t, card)


def reader(name):
    return harness.load_module(harness.HERE / "layer_metrics" / f"{name}.py",
                               f"reader_{name.replace('.', '_')}")


def test_k2_roofline_counts_seven_bytes_a_pixel():
    t = trace.reduce(synthetic())
    run = run_of({"batch": 8}, t, {"train_source_hw": [720, 1280]})
    least = 7 * 8 * 720 * 1280 / 3.35e12
    assert reader("k2_remap_roofline").read(run) == pytest.approx(
        100 * least / 0.001)
    assert reader("k2_remap_roofline").read(
        run_of({"batch": 8}, t, {"train_source_hw": [720, 1280]},
               card="cpu")) is None


def test_idle_stage_and_transform_readers():
    t = trace.reduce(synthetic())
    run = run_of({"batches": 2, "steps": 2}, t)
    assert reader("idle_pct.serve").read(run) == pytest.approx(
        100 * (1 - 0.004 / 0.012))
    assert reader("stage_ms.serve").read(run) == pytest.approx(1.0)
    assert reader("transform_ms.train").read(run) == pytest.approx(0.5)
    assert reader("peak_mem_gb.train").read(
        run_of({"window_peak_bytes": 3e9}, t)) == pytest.approx(3.0)


def test_mfu_readers_divide_the_frozen_count_by_the_window():
    t = trace.reduce(synthetic())
    cfg = json.loads((ROOT / "benchmark/configs/bisenet_r18.json")
                     .read_text())
    from benchmark.reference import models
    per_frame = flops.forward_flops(models.network("bisenet", 19), 1,
                                    (1024, 2048))
    assert 200e9 < per_frame < 210e9
    run = run_of({"frames": 10}, t, cfg)
    assert reader("mfu.serve").read(run) == pytest.approx(
        100 * 10 * per_frame / (0.012 * 989e12))
    assert reader("mfu.serve").read(run_of({"frames": 10}, t, cfg,
                                           card="cpu")) is None


def test_stream_rate_is_over_the_whole_window(tiny_bench):
    """frames_per_s counts the frames whose masks came back within the
    window, over the window's length; the p95 is over every frame."""
    out = harness.run_cell(tiny_bench, "tiny_bisenet_r18.stream", 5, 1.0,
                           False, "cpu", 0.0, ROOT, (DATA, harness.HERE))
    fps = out["metrics"]["frames_per_s"]["value"]
    assert fps > 0 and (fps * 1.0) % 2 == 0  # whole batches of 2
    assert out["attempted"] >= fps * 1.0
    assert out["metrics"]["frame_latency_p95_ms"]["value"] > 0
    assert out["correct"] is True
    assert list(out)[-1] == "checks"

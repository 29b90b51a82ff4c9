"""A cell defined entirely in test data: its configuration, traffic,
limits and one per-layer metric are files under ``data/`` and entries of
``data/bench.json``; the harness runs it with nothing edited."""

from __future__ import annotations

from benchmark import harness
from benchmark.tests.conftest import DATA, ROOT


def test_a_test_data_cell_runs_and_reads_its_own_metric(tiny_bench):
    assert not (harness.HERE / "layer_metrics"
                / "steps_seen.train.py").exists()
    out = harness.run_cell(tiny_bench, "tiny_bisenet_r18.da_v1", 31, 0.5,
                           True, "cpu", 0.0, ROOT, (DATA, harness.HERE))
    metrics = out["metrics"]
    assert metrics["steps_seen.train"]["value"] == out["attempted"] >= 1
    assert metrics["steps_seen.train"]["unit"] == "steps"
    # readers that find nothing to read on the CPU stay out of the line
    assert "mfu.train" not in metrics
    assert "k2_remap_roofline" not in metrics
    assert set(out["device"]) >= {"busy_s", "window_s"}
    assert len(out["breakdown"]["idle_gaps"]) <= 10
    assert list(out)[-1] == "checks"


def test_untraced_lines_carry_the_end_to_end_metrics_only(tiny_bench):
    out = harness.run_cell(tiny_bench, "tiny_bisenet_r18.da_v1", 32, 0.5,
                           False, "cpu", 0.0, ROOT, (DATA, harness.HERE))
    assert set(out["metrics"]) == {"train_images_per_s", "setup_s"}
    assert out["device"]["platform"] == "cpu"


def test_both_training_cells_report_the_one_rate(tiny_bench):
    """Both configurations' DA cells report ``train_images_per_s`` from
    the same driver, and the seconds of each step of set-up."""
    out = harness.run_cell(tiny_bench, "tiny_deeplabv2_r101.da_v1", 33, 0.5,
                           False, "cpu", 0.0, ROOT, (DATA, harness.HERE))
    assert set(out["metrics"]) == {"train_images_per_s", "setup_s"}
    steps = out["setup_steps"]
    assert list(steps)[-1] == "to_window"
    assert {"pools", "weights", "program_build", "checked_steps",
            "warmup"} <= set(steps)
    assert out["counters"]["window_host"]["wall_s"] > 0

"""The served frames' share of the card's dense bf16 peak: frames of the
traced window times the reference forward's FLOPs a frame (the frozen
counter), over the traced window."""

from benchmark import flops
from benchmark.reference import models


def read(run):
    peak = flops.peak(run.card, "bf16_flops")
    if run.trace is None or peak is None or not run.counters.get("frames"):
        return None
    cfg = run.cell.config
    per_frame = flops.forward_flops(
        models.network(cfg["reference"], int(cfg["num_classes"])), 1,
        tuple(cfg["serve_hw"]))
    return 100.0 * run.counters["frames"] * per_frame \
        / (run.trace.window_s * peak)

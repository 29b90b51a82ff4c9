"""The steps' share of the card's dense bf16 peak: steps of the traced
window times the FLOPs of one v1 step at the cell's shapes (the frozen
counter on the reference networks, forward and backward, no recompute),
over the traced window."""

from benchmark import flops
from benchmark.reference import models


def read(run):
    peak = flops.peak(run.card, "bf16_flops")
    if run.trace is None or peak is None or not run.counters.get("steps"):
        return None
    cfg = run.cell.config
    classes = int(cfg["num_classes"])
    per_step = flops.da_step_flops(
        models.network(cfg["reference"], classes),
        models.network(cfg["reference_discriminator"], classes),
        int(run.counters["batch"]),
        tuple(cfg["train_source_hw"]), tuple(cfg["train_target_hw"]))
    return 100.0 * run.counters["steps"] * per_step \
        / (run.trace.window_s * peak)

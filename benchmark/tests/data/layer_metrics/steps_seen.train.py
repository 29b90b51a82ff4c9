"""A per-layer metric that only the test data defines: the steps of the
window, as the driver counted them."""


def read(run):
    return run.counters.get("steps")

"""K2's (the RGB -> trainId remap's) share of its roofline: the least time
its bytes take at the card's HBM rate, 7 bytes a pixel (3 read, 4
written), over its mean device time a launch, by kernel name.  A launch
remaps one source batch."""

from benchmark import flops

KERNEL = "remap_kernel"
BYTES_PER_PIXEL = 7


def read(run):
    rate = flops.peak(run.card, "hbm_bytes_per_s")
    if run.trace is None or rate is None:
        return None
    launches, seconds = run.trace.kernel_s(KERNEL)
    if not launches:
        return None
    h, w = run.cell.config["train_source_hw"]
    least = BYTES_PER_PIXEL * run.counters["batch"] * h * w / rate
    return 100.0 * least / (seconds / launches)

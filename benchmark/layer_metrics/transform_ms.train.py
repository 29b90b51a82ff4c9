"""Device milliseconds a step of the work the host launched inside the
benchmark's ``bench.transform`` spans (``ops/preprocess.make_transform``
on both batches: the label remap K2, the normalization, the label clamp)."""


def read(run):
    if run.trace is None or not run.counters.get("steps"):
        return None
    seconds = run.trace.span_kernel_s.get("bench.transform")
    if not seconds:
        return None
    return 1e3 * seconds / run.counters["steps"]

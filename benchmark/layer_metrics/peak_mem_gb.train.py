"""The most device memory allocated during the window, in GB (1e9
bytes)."""


def read(run):
    peak = run.counters.get("window_peak_bytes")
    return peak / 1e9 if peak else None

"""Device milliseconds a batch of the host-to-device and device-to-host
copies (the serving layer's staging and fetch), from the trace."""


def read(run):
    if run.trace is None or not run.counters.get("batches"):
        return None
    seconds = sum(run.trace.copies.get(kind, (0, 0.0))[1]
                  for kind in ("HtoD", "DtoH"))
    return 1e3 * seconds / run.counters["batches"]

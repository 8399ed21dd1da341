"""Percent of the traced window in which no kernel, copy or set ran on the
device; None where the trace holds no device activity (a run on the CPU)."""


def read(observed):
    if observed.trace is None or not observed.trace.device_spans():
        return None
    return 100.0 * (1.0 - observed.trace.busy_s() / observed.trace.window_s())

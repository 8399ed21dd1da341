"""Mean seconds an assembly's scan waits for the feeder's next staged batch
(`io/stream.DeviceFeeder`: feeder starvation): the program's span
``scan.wait`` in the traced window; None where it has none (out of core
the batches are staged in the count, with no feeder)."""

from gabench.spans import mean_span_s


def read(observed):
    return mean_span_s(observed, "scan.wait")

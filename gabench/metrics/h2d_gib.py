"""Mean GiB an assembly hands to the card: the read batches (each pass of
an out-of-core count again), the kept keys sent back after an out-of-core
count, the state ids the device materializer gathers: the program's
counter ``h2d_bytes`` in the traced window; None where it has none."""

from gabench.spans import mean_count


def read(observed):
    n = mean_count(observed, "h2d_bytes")
    return None if n is None else n / 2**30

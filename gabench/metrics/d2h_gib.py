"""Mean GiB an assembly reads back from the card in arrays larger than a
scalar: the materializer's inputs, the out-of-core count's parked kept keys:
the program's counter ``d2h_bytes`` in the traced window; None where it
has none."""

from gabench.spans import mean_count


def read(observed):
    n = mean_count(observed, "d2h_bytes")
    return None if n is None else n / 2**30

"""Mean seconds an assembly spends in the materializer's walk sort (the
host `np.lexsort` in core; out of core the device sort up to its read-back
of the walk's length): the program's span ``materialize.sort`` in the traced
window; None where it has none."""

from gabench.spans import mean_span_s


def read(observed):
    return mean_span_s(observed, "materialize.sort")

"""Mean seconds an assembly spends scattering encoded reads into padded rows
in `io/reads.batch_reads` (row and column indices, the zeroed codes, the
scatter): the program's span ``batch.scatter`` in the traced window; None
where it has none."""

from gabench.spans import mean_span_s


def read(observed):
    return mean_span_s(observed, "batch.scatter")

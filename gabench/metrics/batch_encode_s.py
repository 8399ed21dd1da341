"""Mean seconds an assembly spends encoding reads in `io/reads.batch_reads`
(the length check, the join and encode, the table lookup): the program's
span ``batch.encode`` in the traced window; None where it has none."""

from gabench.spans import mean_span_s


def read(observed):
    return mean_span_s(observed, "batch.encode")

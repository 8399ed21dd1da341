"""Mean seconds an assembly spends in the materializer's reverse complements
(every state's on the host in core; the chain heads' out of core): the
program's span ``materialize.revcomp`` in the traced window; None where it
has none."""

from gabench.spans import mean_span_s


def read(observed):
    return mean_span_s(observed, "materialize.revcomp")

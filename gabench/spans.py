"""The program's own steps and counters, as its trace holds them.

The port opens one trace range ``<phase>.<step>`` around each step of a
phase that it times, and ends each phase that counted something with one
zero-length range ``<phase>.<counter>=<n>`` a counter (its
``utils/profiling``).  These read both in a traced window, per assembly;
None where the window holds none (an untraced run, a path without the
step, or a program that has no such span or counter).
"""


def _window_ranges(observed):
    """(name, start, end) of the host ranges inside the traced window, or
    None without a trace."""
    trace = observed.trace
    if trace is None:
        return None
    return [(name, a, b) for name, a, b in trace.ranges if trace.lo <= a and b <= trace.hi]


def mean_span_s(observed, name: str):
    """Mean seconds an assembly of the window spent in the step ``name``
    (``<phase>.<step>``)."""
    ranges = _window_ranges(observed)
    spans = [b - a for n, a, b in ranges or () if n == name]
    if not spans:
        return None
    return sum(spans) / 1e6 / len(observed.assemblies)


def mean_count(observed, counter: str):
    """Mean of the counter ``counter`` an assembly of the window, summed
    over its phases."""
    total, seen = 0, False
    for name, _, _ in _window_ranges(observed) or ():
        key, marked, value = name.partition("=")
        if marked and key.rsplit(".", 1)[-1] == counter:
            total += int(value)
            seen = True
    return total / len(observed.assemblies) if seen else None

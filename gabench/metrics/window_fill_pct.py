"""Share of the window slots K1 wrote that hold a window: 100 x the
program's counter ``windows`` over its counter ``slots`` in the traced
window (every launch: each out-of-core pass's re-scans and its probe
too).  Rows padded past a read's length, and batches padded past the last
read, are the empty rest.  None where the program has neither counter."""

from gabench.spans import mean_count


def read(observed):
    windows, slots = mean_count(observed, "windows"), mean_count(observed, "slots")
    if windows is None or not slots:
        return None
    return 100.0 * windows / slots

"""Mean GiB an assembly's out-of-core count allocates on the card to stage
its partitions (every pass's staging buffers, and each re-extracted
partition): the program's counter ``staged_bytes`` in the traced window;
None where it has none (an in-core count, or a program without the
counter)."""

from gabench.spans import mean_count


def read(observed):
    n = mean_count(observed, "staged_bytes")
    return None if n is None else n / 2**30

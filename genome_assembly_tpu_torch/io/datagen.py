"""Synthetic read-set generation (host only).

``generate_coverage_reads`` draws from Python's ``random`` exactly as the
JAX package's generator does, so the same seed gives the same genome and
reads in both packages.
"""

from __future__ import annotations

import random
from typing import List, Tuple


def write_reads(reads: List[str], path: str) -> None:
    with open(path, "w") as f:
        for r in reads:
            f.write(r + "\n")


def generate_coverage_reads(
    genome_len: int,
    read_len: int,
    coverage: float,
    seed: int = 7,
    error_rate: float = 0.0,
    with_reverse: bool = False,
) -> Tuple[str, List[str], List[int]]:
    """Uniform-coverage read simulator.

    Returns (genome, reads, start positions).  ``with_reverse`` emits true
    reverse-complement reads for half the set.
    """
    rng = random.Random(seed)
    letters = "ACGT"
    genome = "".join(rng.choice(letters) for _ in range(genome_len))
    n_reads = int(genome_len * coverage / read_len)
    comp = str.maketrans("ACGT", "TGCA")
    reads, starts = [], []
    for _ in range(n_reads):
        s = rng.randrange(0, genome_len - read_len + 1)
        r = genome[s : s + read_len]
        if error_rate > 0.0:
            chars = list(r)
            for i in range(len(chars)):
                if rng.random() < error_rate:
                    chars[i] = rng.choice(letters)
            r = "".join(chars)
        if with_reverse and rng.random() < 0.5:
            r = r.translate(comp)[::-1]
        reads.append(r)
        starts.append(s)
    return genome, reads, starts

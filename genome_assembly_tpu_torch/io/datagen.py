"""Synthetic read-set generation (host only).

Every generator draws from Python's ``random`` exactly as the JAX
package's does, so the same seed gives the same genome and reads in both
packages.  ``generate_reads`` reimplements the reference harness's
generator (generate_reads.py:93-112): a random genome plus read start
positions drawn by a random walk of triangular distributions (high overlap
between successive reads).  Unlike the reference -- which seeds the RNG
only *after* creating the genome, so the genome differs per run
(generate_reads.py:96-97) -- both genome and positions are seeded here;
pass ``reference_quirk=True`` to reproduce the unseeded-genome behavior.
"""

from __future__ import annotations

import random
from typing import List, Tuple


def generate_reads(
    genome_len: int = 500,
    read_len: int = 30,
    read_num: int = 20,
    seed: int = 20,
    genome_seed: int | None = 7,
    reference_quirk: bool = False,
) -> Tuple[str, List[int]]:
    """Return (genome, read start positions).

    Positions follow the reference's triangular random walk
    (generate_reads.py:103-106): each mode is the previous draw.
    """
    letters = "ACGT"
    if reference_quirk or genome_seed is None:
        rng_g = random.Random()
    else:
        rng_g = random.Random(genome_seed)
    genome = "".join(rng_g.choice(letters) for _ in range(genome_len))
    rng = random.Random(seed)
    hi = genome_len - 1 - read_len
    mode = rng.randint(0, hi)
    starts = []
    for _ in range(read_num):
        mode = int(rng.triangular(0, hi, mode))
        starts.append(mode)
    return genome, starts


def reads_from_starts(genome: str, starts: List[int], read_len: int) -> List[str]:
    """Extract the read strings (generate_reads.py:109-112)."""
    return [genome[s : s + read_len] for s in starts]


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

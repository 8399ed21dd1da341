"""The read generator: one genome and one read set from a seed.

A frozen copy of the port's ``chip_smoke.coverage_reads`` (uniform
coverage, half the reads reverse-complemented, a share of the bases
substituted by another base, all in vectorised numpy), with planted
repeats added: copies of one random segment at spread-out places of the
genome, each in a random orientation, as a genome's rRNA operons or
transposons are.  It lives here, and not in the program, so that a change
to the program cannot change the inputs it is measured on.

Everything is drawn from ``numpy.random.default_rng(seed)`` in a fixed
order, so a seed gives the same reads on every machine; every seed gives
the same numbers of reads and bases.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)
COMPLEMENT = np.zeros(256, dtype=np.uint8)
COMPLEMENT[LETTERS] = np.frombuffer(b"TGCA", dtype=np.uint8)


@dataclasses.dataclass
class ReadSet:
    """reads: [n_reads, read_len] ASCII bytes (ACGT), in file order."""

    reads: np.ndarray

    @property
    def n_reads(self) -> int:
        return self.reads.shape[0]

    def write(self, f) -> None:
        """Write the reads to an open binary file, one read per line."""
        n, length = self.reads.shape
        out = np.empty((n, length + 1), dtype=np.uint8)
        out[:, :length] = self.reads
        out[:, length] = ord("\n")
        out.tofile(f)


def rng_for(seed: int) -> np.random.Generator:
    """The generator of a run: any whole number is a seed (negative ones
    are taken modulo 2**64)."""
    return np.random.default_rng(int(seed) % (1 << 64))


def plant_repeats(genome: np.ndarray, rng: np.random.Generator, length: int, copies: int) -> list:
    """Overwrite ``copies`` places of ``genome`` with one random segment of
    ``length`` bases, a copy in each of ``copies`` equal slices of the
    genome at a random offset, each copy forward or reverse-complemented.
    Returns the copies' start positions."""
    if copies < 1:
        return []
    slot = genome.size // copies
    if length > slot:
        raise ValueError(f"{copies} copies of {length} bases do not fit a genome of {genome.size}")
    segment = LETTERS[rng.integers(0, 4, size=length)]
    starts = [i * slot + int(rng.integers(0, slot - length + 1)) for i in range(copies)]
    flips = rng.random(copies) < 0.5
    for start, flip in zip(starts, flips):
        genome[start:start + length] = COMPLEMENT[segment][::-1] if flip else segment
    return starts


def read_count(genome_len: int, coverage: float, read_len: int) -> int:
    """Reads that give ``coverage`` of a genome."""
    return int(genome_len * coverage / read_len)


def make_reads(seed: int, *, genome_len: int, read_len: int, coverage: float,
               reverse_share: float, substitution_rate: float,
               repeats: tuple = ()) -> ReadSet:
    """Uniform-coverage reads of a random genome with planted repeats.

    repeats: ``(length, copies)`` pairs, planted in order."""
    rng = rng_for(seed)
    genome = LETTERS[rng.integers(0, 4, size=genome_len)]
    for length, copies in repeats:
        plant_repeats(genome, rng, int(length), int(copies))
    n_reads = read_count(genome_len, coverage, read_len)
    read_starts = rng.integers(0, genome_len - read_len + 1, size=n_reads)
    chars = np.empty((n_reads, read_len), dtype=np.uint8)
    for lo in range(0, n_reads, 1 << 20):
        hi = min(n_reads, lo + (1 << 20))
        chars[lo:hi] = genome[read_starts[lo:hi, None] + np.arange(read_len)[None, :]]
    flip = rng.random(n_reads) < reverse_share
    chars[flip] = COMPLEMENT[chars[flip]][:, ::-1]
    if substitution_rate:
        code = np.zeros(256, dtype=np.int64)
        code[LETTERS] = np.arange(4)
        flat = chars.reshape(-1)
        pos = rng.integers(0, flat.size, size=rng.binomial(flat.size, substitution_rate))
        flat[pos] = LETTERS[(code[flat[pos]] + rng.integers(1, 4, size=pos.size)) % 4]
    return ReadSet(chars)


def for_cell(seed: int, config: dict, traffic: dict) -> ReadSet:
    """The read set of one cell: the configuration's genome under the
    traffic mix's sequencing."""
    genome = config["genome"]
    return make_reads(
        seed,
        genome_len=genome["length"],
        read_len=traffic["read_len"],
        coverage=traffic["coverage"],
        reverse_share=traffic["reverse_share"],
        substitution_rate=traffic["substitution_rate"],
        repeats=tuple((r["length"], r["copies"]) for r in genome.get("repeats", ())),
    )

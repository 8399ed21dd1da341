"""The read generator and the sizes of the benchmark's cells."""

import json
import math

import numpy as np
import pytest

from conftest import REPO
from gabench import generate

SMALL = dict(genome_len=20000, read_len=100, coverage=10, reverse_share=0.5,
             substitution_rate=0.001, repeats=((800, 4),))


def test_same_seed_same_reads_and_other_seeds_other_reads():
    big = 2**31 + 977
    a = generate.make_reads(big, **SMALL)
    b = generate.make_reads(big, **SMALL)
    c = generate.make_reads(big + 1, **SMALL)
    assert np.array_equal(a.reads, b.reads)
    assert not np.array_equal(a.reads, c.reads)
    assert a.reads.shape == c.reads.shape == (2000, 100)
    assert set(np.unique(a.reads).tobytes()) <= set(b"ACGT")
    assert generate.make_reads(-5, **SMALL).reads.shape == (2000, 100)


def test_half_the_reads_reverse_complemented_with_the_stated_errors():
    forward = generate.make_reads(7, **dict(SMALL, substitution_rate=0.0, reverse_share=0.0))
    either = generate.make_reads(7, **dict(SMALL, substitution_rate=0.0))
    noisy = generate.make_reads(7, **SMALL)
    rc = generate.COMPLEMENT[forward.reads][:, ::-1]
    same = (either.reads == forward.reads).all(axis=1)
    flipped = (either.reads == rc).all(axis=1)
    assert (same | flipped).all()
    assert 0.45 < flipped.mean() < 0.55
    assert 0.0007 < (noisy.reads != either.reads).mean() < 0.0013


def test_planted_repeats_are_copies_of_one_segment_on_either_strand():
    rng = generate.rng_for(3)
    genome = generate.LETTERS[rng.integers(0, 4, size=50000)]
    starts = generate.plant_repeats(genome, rng, 1200, 7)
    assert len(starts) == 7 and sorted(starts) == starts
    assert all(b - a >= 1200 for a, b in zip(starts, starts[1:]))
    first = genome[starts[0]:starts[0] + 1200]
    for s in starts[1:]:
        copy = genome[s:s + 1200]
        assert (np.array_equal(copy, first)
                or np.array_equal(copy, generate.COMPLEMENT[first][::-1]))
    with pytest.raises(ValueError):
        generate.plant_repeats(genome, rng, 10000, 7)


@pytest.mark.parametrize("cell, reads, batches, slots, in_core, partitions", [
    ("ecoli_mg1655.hiseq50", 2_320_826, 142, 227_999_744, True, None),
    ("yeast_s288c.hiseq50", 6_078_552, 372, 597_295_104, False, 5),
])
def test_cell_sizes(cell, reads, batches, slots, in_core, partitions):
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    (w,) = [w for w in spec["workloads"] if w["name"] == cell]
    config = json.loads((REPO / f"gabench/configs/{w['config']}.json").read_text())
    traffic = json.loads((REPO / f"gabench/traffic/{w['traffic']}.json").read_text())
    p = config["pipeline"]
    n = generate.read_count(config["genome"]["length"], traffic["coverage"], traffic["read_len"])
    assert n == reads
    assert math.ceil(n / p["batch_reads"]) == batches
    # the program's own sums (FastAssembler.unitigs)
    total = batches * p["batch_reads"] * (p["max_read_len"] - p["k"] + 1)
    assert total == slots
    assert (total * 8 <= p["outofcore_bytes"]) == in_core
    if partitions:
        assert math.ceil(total * 8 / (p["outofcore_bytes"] / 3)) == partitions
    # one run writes the reads once: at most 0.62 GB
    assert n * (traffic["read_len"] + 1) <= 0.62e9

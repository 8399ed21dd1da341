"""The plain reference and the comparison that decides ``correct``."""

import collections
import random

import numpy as np
import pytest
import torch

from gabench import control, generate
from gabench.reference import dbg_unitigs as ref

CPU = torch.device("cpu")


def rc(s):
    return s[::-1].translate(str.maketrans("ACGT", "TGCA"))


def canon(s):
    return min(s, rc(s))


def naive_unitigs(reads, k, cutoff):
    """Unitigs by walking a dict of k-mer strings, one k-mer at a time."""
    counts = collections.Counter(canon(r[i:i + k]) for r in reads for i in range(len(r) - k + 1))
    kept = {x for x, c in counts.items() if c > cutoff}
    succs = lambda v: [v[1:] + b for b in "ACGT" if canon(v[1:] + b) in kept]  # noqa: E731
    preds = lambda v: [b + v[:-1] for b in "ACGT" if canon(b + v[:-1]) in kept]  # noqa: E731

    def nxt(v):
        s = succs(v)
        return s[0] if len(s) == 1 and len(preds(s[0])) == 1 and s[0] != rc(v) else None

    def prv(v):
        p = preds(v)
        return p[0] if len(p) == 1 and len(succs(p[0])) == 1 and v != rc(p[0]) else None

    seen, out = set(), []
    for x in sorted(kept):
        if x in seen:
            continue
        start = x
        while (p := prv(start)) is not None and p != x:
            start = p
        spelled, v = start, start
        seen.add(canon(v))
        # a cycle's spelling closes on itself: its last k - 1 bases are start's first
        while (t := nxt(v)) is not None and t != start:
            spelled += t[-1]
            seen.add(canon(t))
            v = t
        out.append(spelled)
    return kept, out


def reads_array(reads):
    return np.frombuffer("".join(reads).encode(), dtype=np.uint8).reshape(len(reads), -1)


def forms(spellings, k):
    return collections.Counter(ref.strand_free(s, k) for s in spellings)


def reference_unitigs(reads, k, cutoff):
    kept = ref.kept_kmers(reads_array(reads), k, cutoff, CPU)
    return kept, ref.unitig_spellings(kept, k)


def test_a_branch_splits_three_unitigs():
    reads = ["GATTACAGGTC", "GATTACATTGA"]
    _, spellings = reference_unitigs(reads, 5, 0)
    assert forms(spellings, 5) == forms(["GATTACA", "TACAGGTC", "TACATTGA"], 5)


def test_one_read_is_one_unitig_and_the_cutoff_drops_singletons():
    read = "ACGGTCATTAGCCTTGAGT"
    _, spellings = reference_unitigs([read], 7, 0)
    assert forms(spellings, 7) == forms([read], 7)
    kept, spellings = reference_unitigs([read], 7, 1)
    assert kept.numel() == 0 and spellings == []
    # seen twice (once on each strand) it is kept
    _, spellings = reference_unitigs([read, rc(read)], 7, 1)
    assert forms(spellings, 7) == forms([read], 7)


def test_a_circular_genome_is_one_cycle_free_of_its_start():
    circle = "TTAGTTGTGCCGCAGCGAAGTAGTG"  # no 6-mer twice, on either strand
    k = 7
    reads = [(circle * 3)[i:i + 12] for i in range(len(circle))]
    _, spellings = reference_unitigs(reads, k, 0)
    assert len(spellings) == 1
    (s,) = spellings
    assert s[:k - 1] == s[-(k - 1):] and len(s) == len(circle) + k - 1
    other_start = (circle * 2)[5:5 + len(circle)]
    assert ref.strand_free(s, k) == ref.strand_free(rc(other_start + other_start[:k - 1]), k)


@pytest.mark.parametrize("seed", range(6))
def test_reference_equals_a_walk_of_kmer_strings(seed):
    rng = random.Random(seed)
    k = rng.choice([5, 7, 9, 11])
    made = generate.make_reads(seed, genome_len=rng.randrange(300, 2000), read_len=30,
                               coverage=rng.choice([4, 10]), reverse_share=0.5,
                               substitution_rate=0.01, repeats=((k + 20, 3),))
    reads = [r.tobytes().decode() for r in made.reads]
    cutoff = rng.choice([0, 1])
    kept, spellings = reference_unitigs(reads, k, cutoff)
    naive_kept, naive = naive_unitigs(reads, k, cutoff)
    assert kept.numel() == len(naive_kept)
    assert forms(spellings, k) == forms(naive, k)


def test_least_rotation_is_the_least_of_all_rotations():
    rng = random.Random(0)
    for _ in range(300):
        s = "".join(rng.choice("AC") for _ in range(rng.randrange(1, 12)))
        assert ref.least_rotation(s) == min(s[i:] + s[:i] for i in range(len(s)))


def judged(reads, k, cutoff, loaded, output):
    expected = ref.Expected(reads_array(reads), {"k": k, "abundance_cutoff": cutoff}, CPU)
    return expected, ref.judge(expected, loaded, output, CPU)


def test_judge_counts_each_kind_of_mismatch():
    made = generate.make_reads(11, genome_len=3000, read_len=40, coverage=12, reverse_share=0.5,
                               substitution_rate=0.005, repeats=((60, 3),))
    reads = [r.tobytes().decode() for r in made.reads]
    k = 9
    expected, clean = judged(reads, k, 1, reads, ref.unitig_spellings(
        ref.kept_kmers(made.reads, k, 1, CPU), k))
    assert clean == dict.fromkeys(ref.LIMITS, 0)
    good = [rc(s) if i % 2 else s for i, s in enumerate(expected.spellings)]
    assert ref.judge(expected, reads, good, CPU) == dict.fromkeys(ref.LIMITS, 0)
    longest = max(range(len(good)), key=lambda i: len(good[i]))
    s = good[longest]
    mid = len(s) // 2
    altered = good[:longest] + [s[:mid] + ("A" if s[mid] != "A" else "C") + s[mid + 1:]] + (
        good[longest + 1:])
    got = ref.judge(expected, reads, altered, CPU)
    assert got["unitigs_diff"] == 2 and got["kmers_diff"] > 0 and got["reads_diff"] == 0
    got = ref.judge(expected, reads, good[1:], CPU)
    assert got["unitigs_diff"] == 1 and got["ends_diff"] == 1 and got["kmers_diff"] > 0
    got = ref.judge(expected, reads, good + good[:1], CPU)
    assert got["unitigs_diff"] == 1 and got["kmers_diff"] == len(good[0]) - k + 1
    split = good[:longest] + [s[:mid + k - 1], s[mid:]] + good[longest + 1:]
    got = ref.judge(expected, reads, split, CPU)
    assert got["ends_diff"] == 3 and got["kmers_diff"] == 0
    assert ref.judge(expected, reads, good + ["ACGN" * 5], CPU)["kmers_diff"] > 0
    assert ref.judge(expected, reads[:-1], good, CPU)["reads_diff"] == 1
    assert ref.judge(expected, [reads[0][::-1]] + reads[1:], good, CPU)["reads_diff"] == 1


def test_control_counts_by_fingerprint_and_is_not_correct():
    """The control at a size a test holds: 200 kb at 50x with the traffic's
    errors has about 0.3 M distinct k-mers, so 32-bit fingerprints collide
    some tens of times and keep error k-mers the exact count drops."""
    made = generate.make_reads(2**31 + 5, genome_len=200_000, read_len=100, coverage=50,
                               reverse_share=0.5, substitution_rate=0.001, repeats=((5000, 7),))
    params = {"k": 31, "abundance_cutoff": 1}
    expected = ref.Expected(made.reads, params, CPU)
    spellings = control.control_spellings(made.reads, params, CPU)
    loaded = [r.tobytes().decode() for r in made.reads]
    assert ref.judge(expected, loaded, expected.spellings, CPU) == dict.fromkeys(ref.LIMITS, 0)
    got = ref.judge(expected, loaded, spellings, CPU)
    assert got["kmers_diff"] > ref.LIMITS["kmers_diff"]
    assert got["unitigs_diff"] > ref.LIMITS["unitigs_diff"]

"""Visual validation plots (SURVEY.md section 5.5, item 13).

Continuity with the reference harness's human-in-the-loop validation
(generate_reads.py:14-135): read-coverage bitmaps (reads.png), k-mers per
m-mer bin bars (mmers.png), and unitig-vs-genome placement bitmaps
(kmers.png).  Matplotlib is imported lazily so headless/metric-only runs
never pay for it.
"""

from __future__ import annotations

from typing import Dict, Sequence


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    return plt


def plot_reads(starts: Sequence[int], genome_len: int, read_len: int, path: str) -> None:
    """Read-coverage bitmap, one row per read (reads.png equivalent)."""
    import numpy as np

    plt = _plt()
    matrix = np.zeros((len(starts), genome_len), dtype=int)
    for i, s in enumerate(starts):
        matrix[i, s : s + read_len] = 1
    plt.figure(figsize=(20, 10))
    plt.imshow(matrix, interpolation="nearest", cmap="gray_r", aspect="auto")
    plt.xlabel("genome position")
    plt.ylabel("read")
    plt.savefig(path)
    plt.close()


def plot_mmer_bins(bin_counts: Dict[str, int], path: str) -> None:
    """k-mers per m-mer bin (mmers.png equivalent)."""
    plt = _plt()
    names = list(bin_counts)
    plt.figure(figsize=(max(6, len(names) * 0.3), 4))
    plt.bar(range(len(names)), [bin_counts[n] for n in names], align="center")
    plt.xticks(range(len(names)), names, rotation="vertical", fontsize=8)
    plt.tight_layout()
    plt.savefig(path)
    plt.close()


def parse_verbose_output(text: str):
    """Parse print_kmer_read_ids-format output (the format the reference
    harness's plot_unitigs consumes, generate_reads.py:24-62).

    Returns (bin_counts, unitigs): k-mers per m-mer bin, and per unitig a
    (key, per-bp read-id lists) pair.
    """
    bin_counts: Dict[str, int] = {}
    unitigs = []
    lines = text.splitlines()
    i = 0
    mmer = ""
    while i < len(lines):
        if not lines[i]:
            mmer = ""
            i += 1
            continue
        if not mmer:
            mmer = lines[i]
            bin_counts.setdefault(mmer, 0)
            i += 1
            continue
        key = lines[i]
        bin_counts[mmer] += 1
        i += 1
        per_bp = []
        for _ in range(len(key)):
            per_bp.append([int(x) for x in lines[i].split()])
            i += 1
        unitigs.append((key, per_bp))
    return bin_counts, unitigs


def plot_unitig_placement(
    unitigs: Sequence[str], genome: str, path: str
) -> None:
    """Unitig-vs-genome placement bitmap (kmers.png equivalent).

    Each unitig row marks the genome positions it aligns to (exact match on
    either strand; unplaced unitigs get an empty row).
    """
    import numpy as np

    plt = _plt()
    comp = str.maketrans("ACGT", "TGCA")
    matrix = np.zeros((len(unitigs), len(genome)), dtype=int)
    for i, u in enumerate(unitigs):
        pos = genome.find(u)
        if pos < 0:
            pos = genome.find(u.translate(comp)[::-1])
        if pos >= 0:
            matrix[i, pos : pos + len(u)] = 1
    plt.figure(figsize=(20, 10))
    plt.imshow(matrix, interpolation="nearest", cmap="gray_r", aspect="auto")
    plt.xlabel("genome position")
    plt.ylabel("unitig")
    plt.savefig(path)
    plt.close()


def placement_matrix_by_read_ids(
    unitigs, read_starts: Sequence[int], genome: str, read_len: int
):
    """[n_unitigs, genome_len] coverage matrix for
    plot_unitig_placement_by_read_ids (split out so tests can assert
    placements without rendering)."""
    import numpy as np

    comp = str.maketrans("ACGT", "TGCA")
    matrix = np.zeros((len(unitigs), len(genome)), dtype=int)
    for i, (key, per_bp) in enumerate(unitigs):
        contributing = sorted({r for ids in per_bp for r in ids})
        for r in contributing:
            if r >= len(read_starts):
                continue
            start = int(read_starts[r])
            window = genome[start : start + read_len]
            chars = "".join(
                c if r in ids else " " for c, ids in zip(key, per_bp)
            )
            for part in chars.split(" "):
                if not part:
                    continue
                idx = window.find(part)
                if idx < 0:
                    idx = window.find(part.translate(comp)[::-1])
                if idx >= 0:
                    matrix[i, start + idx : start + idx + len(part)] = 1
    return matrix


def plot_unitig_placement_by_read_ids(
    unitigs, read_starts: Sequence[int], genome: str, read_len: int,
    path: str,
) -> None:
    """Reference-style placement: map unitigs to the genome THROUGH their
    per-BP read-id lists (generate_reads.py:44-81), not whole-string search.

    For every read contributing to a unitig, the subsequence of unitig
    base pairs carrying that read id is split on gaps and each part is
    searched inside that read's own genome window (forward, then reverse
    complement) -- so a partially wrong unitig still places its
    read-supported fragments instead of one silently empty row, which is
    the exact-search fallback's failure mode on any mismatch (VERDICT
    round 2 missing #2).

    Two reference bugs are NOT reproduced (this is a diagnostic tool, not
    a parity surface): its reverse-strand retry fires only when the
    forward hit is at offset 0 (`if not index:`,
    generate_reads.py:77-78), and a miss (find == -1) marks from
    start-1; here a genuine miss leaves the part unmarked and a
    reverse-complement hit maps back to forward coordinates.

    unitigs: (key, per_bp read-id lists) pairs -- parse_verbose_output's
    format.  read_starts[r] = genome start of read r.
    """
    plt = _plt()
    matrix = placement_matrix_by_read_ids(unitigs, read_starts, genome, read_len)
    plt.figure(figsize=(20, 10))
    plt.imshow(matrix, interpolation="nearest", cmap="gray_r", aspect="auto")
    plt.xlabel("genome position")
    plt.ylabel("unitig")
    plt.savefig(path)
    plt.close()


def parse_verbose_table(text: str):
    """print_kmer_read_ids-format text -> {(mmer, key): per-bp read-id lists}.

    The queryable form of the reference's expanded table
    (expand_read_id_list, binning.c:857-888 + img/expanded_reads.svg): one
    descending read-id list per base pair of every surviving k-mer/unitig.
    Keys can repeat across bins (context-dependent binning, SURVEY.md
    2.1.4), hence the (mmer, key) composite; duplicate (mmer, key) lines
    within one bin keep the last occurrence (reference zhash_set replace
    semantics).
    """
    table = {}
    lines = text.splitlines()
    i = 0
    mmer = ""
    while i < len(lines):
        if not lines[i]:
            mmer = ""
            i += 1
            continue
        if not mmer:
            mmer = lines[i]
            i += 1
            continue
        key = lines[i]
        i += 1
        per_bp = []
        for _ in range(len(key)):
            per_bp.append([int(x) for x in lines[i].split()])
            i += 1
        table[(mmer, key)] = per_bp
    return table

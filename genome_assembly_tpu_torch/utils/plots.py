"""Parser of the verbose output (the print_kmer_read_ids format).

The verbose text lists, per m-mer bin, the bin's m-mer on a line of its
own, then each surviving k-mer or unitig key followed by one line of
descending read ids per base pair, and an empty line closing the bin.
The plotting functions of the JAX package's ``utils/plots.py``, and
``parse_verbose_output`` that feeds them, are not ported yet.
"""

from __future__ import annotations


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

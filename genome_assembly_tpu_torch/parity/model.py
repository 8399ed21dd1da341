"""Executable specification of the reference's per-read window scan.

This is the behavioral contract from SURVEY.md 2.1 written as straightforward
Python; it is the differential oracle the vectorized scan
(``ops/minimizer.parity_scan``) is tested against, and the readable
description of what that scan computes.

Semantics of process_read (binning.c:902-1076), after accounting for the dead
incremental-update branch (binning.c:993-1021 never fires when k >= 2m):

- The "signature" of window i is chosen by a full rescan of the window's
  m-mer positions ONLY when the previous signature's start position has
  fallen behind the window start (pointer comparison ``kmer > signature``,
  binning.c:921).  Otherwise the previous signature carries over unchanged --
  m-mers entering on the right are ignored (the stale-signature quirk).
- A rescan picks the leftmost position maximizing max(fwd_score, comp_score)
  over the window's m-mer start positions (strict-greater update ==
  first-max-wins, binning.c:972).
- The strand flag at the chosen position is ``comp_score >= fwd_score``
  (ties pick the complement, binning.c:942-949, 974-983).
- If the flag is set, BOTH the stored k-mer and its signature m-mer are
  complemented per-position without reversal (binning.c:1029-1040).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

from genome_assembly_tpu_torch.ops.encode import score_str

_COMP = {"T": "A", "G": "C", "C": "G", "A": "T"}


def complement_str(s: str) -> str:
    """Per-position complement, no reversal (binning.c:1031-1039).

    Any character outside uppercase ACGT (including lowercase) is scored as
    'A' by the reference's getval default, so it complements to 'T'.
    """
    return "".join(_COMP.get(ch, "T") for ch in s)


@dataclasses.dataclass(frozen=True)
class WindowRecord:
    """One k-mer window occurrence as the reference would store it."""

    read_id: int
    window: int
    signature: str  # stored (possibly complemented) m-mer string
    kmer: str  # stored (possibly complemented) k-mer string
    sig_pos: int  # signature start position within the read
    is_rev: bool


def scan_read(read: str, read_id: int, k: int, m: int) -> List[WindowRecord]:
    """All window records of one read, in window order."""
    if k < 2 * m:
        raise ValueError("model only defined for k >= 2m (see SURVEY.md 2.1.3)")
    n = len(read)
    records: List[WindowRecord] = []
    if n < k:
        return records
    mask = (1 << (2 * m)) - 1
    # fwd[p] = packed score of read[p:p+m]; comp score is mask - fwd.
    fwd = [score_str(read[p : p + m]) for p in range(n - m + 1)]
    sig_pos = -1
    for i in range(n - k + 1):
        if sig_pos < i:
            # Full rescan over m-mer start positions in [i, i + k - m].
            best_pos, best_val = i, -1
            for p in range(i, i + k - m + 1):
                val = max(fwd[p], mask - fwd[p])
                if val > best_val:
                    best_val = val
                    best_pos = p
            sig_pos = best_pos
        is_rev = (mask - fwd[sig_pos]) >= fwd[sig_pos]
        sig = read[sig_pos : sig_pos + m]
        kmer = read[i : i + k]
        if is_rev:
            sig = complement_str(sig)
            kmer = complement_str(kmer)
        records.append(WindowRecord(read_id, i, sig, kmer, sig_pos, is_rev))
    return records


def scan_reads(reads: Sequence[str], k: int, m: int) -> List[WindowRecord]:
    """Window records for a read set, in stream order (read, then window) --
    the insertion order the parity replay engine depends on."""
    out: List[WindowRecord] = []
    for rid, read in enumerate(reads):
        out.extend(scan_read(read, rid, k, m))
    return out


def count_table(records: Sequence[WindowRecord], cutoff: int):
    """Occurrence counts per (signature, kmer) -- the pruned two-level table
    as a plain dict {(sig, kmer): [read ids, descending]}.

    Counts are occurrences, not distinct reads (binning.c:1060-1069); the
    read-id list is maintained in descending insertion order.  An entry
    survives pruning iff its occurrence count > cutoff (binning.c:1096-1110).
    """
    table: dict = {}
    for rec in records:
        table.setdefault((rec.signature, rec.kmer), []).insert(0, rec.read_id)
    return {
        key: ids for key, ids in table.items() if len(ids) > cutoff
    }

"""Exact parity support for reads containing non-ACGT bytes.

The reference accepts ANY byte: ``getval`` scores unknown characters
(including lowercase bases and 'N') as 'A' (binning.c:107-109), but the
RAW character is stored -- and printed -- verbatim whenever the k-mer is
not complemented (binning.c:1023-1028 copies from the read; the
complement branch at 1036-1039 rewrites through getbp(3 - getval(c)), so
complemented keys are always pure TGCA with unknowns becoming 'T').

Consequently two windows whose 2-bit code sequences are identical can be
DIFFERENT reference table entries (raw "AAN..." vs "AAA..."), which the
device's packed (mmer, kmer) grouping cannot distinguish.  The exact fix
implemented here:

  1. every read still goes through the device scan -- all scoring,
     binning, and strand decisions depend only on getval codes, so the
     device's groups, streams, and counts are the right SKELETON;
  2. reads containing any non-uppercase-ACGT byte ("dirty" reads,
     typically a tiny fraction) are ALSO scanned by the executable spec
     (parity/model.scan_read), which yields each window's exact stored
     strings including raw bytes and the stale-signature position;
  3. each device group is re-keyed per occurrence: occurrences whose
     stream index belongs to a dirty read take their spec strings, the
     rest take the decoded packed strings (for clean reads the two are
     equal by construction); occurrences regroup by exact string pair.

Regrouping can only SPLIT device groups, never merge across them: a
window's stored strings always pack back to its device codes, so
different (mmer, khi, klo) groups can never produce an equal string
pair.  Insertion order and per-group id order follow the stream indices,
exactly as the reference's read loop would have inserted them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from genome_assembly_tpu_torch.ops import encode
from genome_assembly_tpu_torch.parity import model

_PURE = frozenset("ACGT")

Group = Tuple[str, str, List[int]]


def dirty_read_ids(reads: Sequence[str]) -> List[int]:
    """Indices of reads containing any byte outside uppercase ACGT."""
    return [i for i, r in enumerate(reads) if not _PURE.issuperset(r)]


def has_non_acgt(reads: Sequence[str]) -> bool:
    return any(not _PURE.issuperset(r) for r in reads)


def spec_strings_by_stream(
    reads: Sequence[str], dirty: Sequence[int], k: int, m: int, n_win: int
) -> Dict[int, Tuple[str, str]]:
    """stream index -> (signature, kmer) stored strings for every window
    of every dirty read.  Streams are flat (read_row * n_win + window),
    matching CountPipeline's stream_offset numbering (reads are batched
    in order and only the final batch is padded, so global read index ==
    global row index)."""
    out: Dict[int, Tuple[str, str]] = {}
    for r in dirty:
        for rec in model.scan_read(reads[r], r, k, m):
            out[r * n_win + rec.window] = (rec.signature, rec.kmer)
    return out


def regroup_with_exceptions(
    host,
    streams: Sequence[np.ndarray],
    reads: Sequence[str],
    *,
    k: int,
    m: int,
    n_win: int,
) -> List[Group]:
    """Device HostTable (+ per-group occurrence streams) -> insertion-
    ordered STRING groups with raw-byte keys where the reference stores
    them.

    host: parity.table.HostTable (int64 k-mer keys) extracted UNPRUNED (cutoff must be
    applied after regrouping -- splitting a group changes counts).
    streams: per-group occurrence stream arrays aligned with
    host.read_ids (table.extract_groups_with_streams).
    """
    dirty = dirty_read_ids(reads)
    spec = spec_strings_by_stream(reads, dirty, k, m, n_win) if dirty else {}

    # (first_seen, mmer_str, kmer_str, ids) -- regrouped occurrence lists
    out: List[Tuple[int, str, str, List[int]]] = []
    for g in range(len(host.mmer)):
        sig0 = encode.unpack_int(int(host.mmer[g]), m)
        kmer0 = encode.unpack_int(int(host.kmer[g]), k)
        ids = host.read_ids[g]
        strm = streams[g]
        touched = [int(s) in spec for s in strm]
        if not any(touched):
            out.append((int(host.first_seen[g]), sig0, kmer0, list(map(int, ids))))
            continue
        # split by exact stored strings, preserving stream order
        sub: Dict[Tuple[str, str], Tuple[int, List[int]]] = {}
        for j in range(len(ids)):
            key = spec[int(strm[j])] if touched[j] else (sig0, kmer0)
            if key in sub:
                sub[key][1].append(int(ids[j]))
            else:
                sub[key] = (int(strm[j]), [int(ids[j])])
        for (sig, kmer), (first, id_list) in sub.items():
            out.append((first, sig, kmer, id_list))

    out.sort(key=lambda t: t[0])
    return [(sig, kmer, id_list) for _, sig, kmer, id_list in out]


def prune_groups(groups: Sequence[Group], cutoff: int) -> List[Group]:
    """Reference pruning over string groups: keep count > cutoff
    (prune_kmers deletes when count <= ABUNDANCE_CUTOFF)."""
    return [g for g in groups if len(g[2]) > cutoff]

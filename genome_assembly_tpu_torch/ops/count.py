"""Sort-based k-mer counting and abundance pruning (fast mode).

Flatten all window records, sort the int64 keys, and read groups off runs
of equal keys.  Pruning is a mask: keep a group iff its occurrence count
is greater than the cutoff.  Invalid records hold ``SENTINEL``, which
sorts past every real key and is masked out of everything.

The sorts are ``torch.sort`` on one int64 key -- the library sort, as the
JAX package leaves the same sorts to ``lax.sort`` outside any kernel.
``count_keys(hybrid_sort=True)`` takes the second route: library sorts of
chunks merged by the hand-written bitonic kernels
(``ops/bitonic_sort.sort_keys_hybrid``), the counterpart of the JAX
package's ``pallas_sort``.  Outputs keep the JAX package's padded shapes
(length of the input, sentinel tail) so the two can be compared row for
row.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from genome_assembly_tpu_torch.common import SENTINEL
from genome_assembly_tpu_torch.ops import bitonic_sort
from genome_assembly_tpu_torch.ops.minimizer import WindowRecords


def group_counts(group_start: torch.Tensor) -> torch.Tensor:
    """Group sizes broadcast to every member (int64).

    group_start: [n] bool, True at the first row of each run; row 0 is a
    run start.  A run's size is the distance between neighbouring run
    starts; a cumsum of the flags numbers the runs.
    """
    n = group_start.shape[0]
    starts = torch.nonzero(group_start).reshape(-1)
    ends = torch.cat([starts[1:], starts.new_full((1,), n)])
    group_id = torch.cumsum(group_start, dim=0) - 1
    return (ends - starts)[group_id]


def _run_starts(key_s: torch.Tensor) -> torch.Tensor:
    """True where a sorted key differs from the one before it."""
    head = torch.ones((min(1, key_s.shape[0]),), dtype=torch.bool, device=key_s.device)
    return torch.cat([head, key_s[1:] != key_s[:-1]])


def _masked_flat_keys(records: WindowRecords) -> torch.Tensor:
    return torch.where(records.valid, records.kmer, SENTINEL).reshape(-1)


class KeyCounts(NamedTuple):
    """Payload-free counted keys: sorted ascending, sentinel tail.

    The kept keys are the pruned canonical k-mer set, already in the order
    the dBG phase needs.  Per-group counts are not materialized here (the
    abundance test needs only a shifted equality); use
    ``key_group_counts`` when actual counts are wanted.
    """

    kmer: torch.Tensor
    valid: torch.Tensor  # real (non-sentinel) rows
    group_start: torch.Tensor
    keep: torch.Tensor


def count_keys(
    records: WindowRecords, *, cutoff: int, hybrid_sort: bool = False
) -> KeyCounts:
    """Count canonical k-mers without carrying read-id payloads.

    A sorted run has length > cutoff iff the element ``cutoff`` positions
    ahead still equals the run head -- one shifted comparison.

    ``hybrid_sort`` sorts with ``sort_keys_hybrid`` instead of one
    ``torch.sort``: on CUDA tensors through the bitonic kernels, on CPU
    tensors through their plain versions.  (The JAX ``pallas_sort`` falls
    back to ``lax.sort`` off the TPU without saying so; nothing here
    switches route silently.)  The result is the same either way.
    """
    key = _masked_flat_keys(records)
    if hybrid_sort:
        key_s = bitonic_sort.sort_keys_hybrid(key)
    else:
        key_s = torch.sort(key).values
    del key
    n = key_s.shape[0]
    valid = key_s != SENTINEL
    group_start = _run_starts(key_s)
    if cutoff <= 0:
        long_enough = torch.ones_like(group_start)
    else:
        # run length > cutoff  <=>  key[i + cutoff] == key[i]; the pad is
        # the sentinel, so on the sentinel tail the compare is true and
        # `valid` is what makes it false
        pad = key_s.new_full((min(cutoff, n),), SENTINEL)
        ahead = torch.cat([key_s[cutoff:], pad])
        long_enough = (ahead == key_s) & valid
    keep = group_start & valid & long_enough
    return KeyCounts(key_s, valid, group_start, keep)


def key_group_counts(kc: KeyCounts) -> torch.Tensor:
    """Per-record group sizes for a KeyCounts (when counts are needed)."""
    return group_counts(kc.group_start)


def _compact_front(values: torch.Tensor, keep: torch.Tensor, fill) -> torch.Tensor:
    """values[keep] at the front of a tensor shaped like ``values``, rest ``fill``."""
    kept = values[keep]
    out = values.new_full(values.shape, fill)
    out[: kept.shape[0]] = kept
    return out


def kept_keys_sorted(kc: KeyCounts):
    """Compact kept group-start keys to the front (they are sorted already).

    Returns (kmer, valid) shaped like the input, sentinel-padded -- the
    input format of ops/dbg.py.  A boolean-mask compaction replaces the
    JAX package's mask-and-sort-again; the arrays are the same.
    """
    kmer = _compact_front(kc.kmer, kc.keep, SENTINEL)
    return kmer, kmer != SENTINEL


def kept_keys_sorted_with_counts(kc: KeyCounts):
    """kept_keys_sorted plus each kept key's occurrence count.

    Returns (kmer, valid, count) all shaped like the input; count (int64)
    aligns row for row with the compacted keys and is 0 on sentinel rows.
    """
    kmer = _compact_front(kc.kmer, kc.keep, SENTINEL)
    count = _compact_front(group_counts(kc.group_start), kc.keep, 0)
    return kmer, kmer != SENTINEL, count


class KeyRidCounts(NamedTuple):
    """Counted keys carrying per-occurrence read ids.

    Sorted by (kmer, read_id): occurrences of one k-mer are adjacent with
    ascending read ids -- the CSR value order.
    """

    kmer: torch.Tensor
    read_id: torch.Tensor
    valid: torch.Tensor
    group_start: torch.Tensor
    count: torch.Tensor
    keep: torch.Tensor


def count_keys_rids(
    records: WindowRecords, read_ids: torch.Tensor, *, cutoff: int
) -> KeyRidCounts:
    """count_keys with a read-id payload (fast-mode provenance).

    records: WindowRecords of any shape; read_ids: int64, same shape as
    records.kmer (window slot -> owning read).  The (kmer, read_id) order
    comes from two stable sorts, minor key first: the pair does not fit
    one int64.
    """
    key = _masked_flat_keys(records)
    rid_s, order = torch.sort(read_ids.reshape(-1), stable=True)
    key_s, order = torch.sort(key[order], stable=True)
    rid_s = rid_s[order]
    valid = key_s != SENTINEL
    group_start = _run_starts(key_s)
    count = group_counts(group_start)
    keep = group_start & valid & (count > cutoff)
    return KeyRidCounts(key_s, rid_s, valid, group_start, count, keep)

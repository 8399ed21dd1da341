"""Sort-based k-mer counting and abundance pruning.

Flatten all window records, sort, and read groups off runs of equal keys.
Pruning is a mask: keep a group iff its occurrence count is greater than
the cutoff.  Invalid records hold ``SENTINEL`` (and, in parity mode,
``MMER_SENTINEL``), which sort past every real key and are masked out of
everything.

Fast mode counts one int64 key per window (``count_keys``).  Parity mode
counts (signature m-mer, k-mer) pairs and carries each occurrence's read
id and stream position through a stable sort (``count_and_prune``,
``merge_sorted_tables``): the replay needs each group's occurrences in
stream order.

The sorts are ``torch.sort`` -- the library sort, as the JAX package
leaves the same sorts to ``lax.sort`` outside any kernel.
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

from genome_assembly_tpu_torch.common import MMER_SENTINEL, SENTINEL
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


class CountedTable(NamedTuple):
    """Sorted, counted, pruned (signature, k-mer) table of parity mode,
    still padded to N records (N = window slots counted).

    Records are sorted by (mmer, kmer); invalid slots hold MMER_SENTINEL /
    SENTINEL at the end.

    mmer: int32 stored signature m-mer; kmer: int64 stored k-mer key.
    read_id: int64 per-occurrence read ids, stream-ordered within a group.
    stream_idx: int64 flat (read, window) stream position of each
      occurrence; the value at a group's first record is the entry's
      insertion time, which the replay uses to rebuild the reference's
      exact hash table layout.
    valid: real (non-sentinel) rows.
    group_start: True at the first record of each distinct (mmer, kmer).
    count: int64 occurrence count of the record's group, on every member.
    keep: group_start & valid & count > cutoff -- one True per surviving
      table entry.
    """

    mmer: torch.Tensor
    kmer: torch.Tensor
    read_id: torch.Tensor
    stream_idx: torch.Tensor
    valid: torch.Tensor
    group_start: torch.Tensor
    count: torch.Tensor
    keep: torch.Tensor

    @property
    def n_entries(self) -> torch.Tensor:
        """Distinct (mmer, kmer) entries before pruning."""
        return (self.group_start & self.valid).sum()

    @property
    def n_kept(self) -> torch.Tensor:
        """Entries surviving the abundance cutoff."""
        return self.keep.sum()


def _mmer_kmer_order(mmer, kmer, minor=None) -> torch.Tensor:
    """The permutation that sorts rows stably by (mmer, kmer[, minor]).

    Least significant lane first: one stable ``torch.sort`` a lane, each
    sorting the lane gathered through the order so far.
    """
    order = None if minor is None else torch.sort(minor, stable=True).indices
    for lane in (kmer, mmer):
        key = lane if order is None else lane[order]
        step = torch.sort(key, stable=True).indices
        order = step if order is None else order[step]
    return order


def _parity_groups(mmer_s, kmer_s, read_id, stream, cutoff: int) -> CountedTable:
    valid = kmer_s != SENTINEL
    n = kmer_s.shape[0]
    group_start = torch.ones(n, dtype=torch.bool, device=kmer_s.device)
    group_start[1:] = (mmer_s[1:] != mmer_s[:-1]) | (kmer_s[1:] != kmer_s[:-1])
    count = group_counts(group_start)
    keep = group_start & valid & (count > cutoff)
    return CountedTable(mmer_s, kmer_s, read_id, stream, valid, group_start, count, keep)


def count_and_prune(
    records: WindowRecords,
    read_ids: torch.Tensor,
    *,
    cutoff: int,
    stream_offset: int = 0,
) -> CountedTable:
    """Count occurrences of each (mmer, kmer) and apply the abundance mask.

    records: parity WindowRecords, [batch, n_windows] tensors.
    read_ids: [batch] int64 read ids (broadcast across windows).
    stream_offset: global stream index of this batch's first window slot
      (batch_index * batch_rows * n_windows when batching uniformly).

    A stable sort by (mmer, kmer) keeps stream order inside each group:
    ascending (read id, window).
    """
    batch, n_win = records.mmer.shape
    valid = records.valid.reshape(-1)
    mmer = torch.where(valid, records.mmer.reshape(-1), MMER_SENTINEL)
    kmer = torch.where(valid, records.kmer.reshape(-1), SENTINEL)
    order = _mmer_kmer_order(mmer, kmer)
    return _parity_groups(
        mmer[order], kmer[order], read_ids[order // n_win], order + stream_offset, cutoff
    )


def merge_sorted_tables(
    tables: list[CountedTable], *, cutoff: int
) -> CountedTable:
    """Merge per-batch counted tables into one, on the device.

    Groups split across batches are re-merged by a stable sort over the
    concatenated records by (mmer, kmer, stream): the global stream index
    is a key, so each group's occurrences come out in stream order
    whatever order the inputs were in.  Per-batch tables should be built
    with cutoff=-1 (keep everything): pruning applies after the merge.
    """
    mmer = torch.cat([t.mmer for t in tables])
    kmer = torch.cat([t.kmer for t in tables])
    valid = torch.cat([t.valid for t in tables])
    mmer = torch.where(valid, mmer, MMER_SENTINEL)
    kmer = torch.where(valid, kmer, SENTINEL)
    stream = torch.cat([t.stream_idx for t in tables])
    order = _mmer_kmer_order(mmer, kmer, minor=stream)
    rid = torch.cat([t.read_id for t in tables])
    return _parity_groups(mmer[order], kmer[order], rid[order], stream[order], cutoff)

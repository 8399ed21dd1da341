"""Out-of-core counting: hash-partitioned multi-pass for record sets past
device memory.

The window records of a large read set do not fit on the device, but they
are cheap to make again: the scan re-runs over each batch.  So each pass
re-scans every batch and extracts a GROUP of G consecutive RANGE
partitions of its records (one sort keyed on a 32-bit hash of the key lays
any number of consecutive partitions out as contiguous runs), then counts
each partition entirely on the device.  G comes from a staging budget
(``range_group_plan``), so the pass count is about the record bytes over
that budget.  The link builder (ops/dbg.py: key + payload) and parity
mode (five lanes) use the same range scheme through their own extractors.

All duplicates of a key share its hash, so a partition's counts are
complete and partitions are disjoint: the union of the partitions' kept
keys IS the pruned k-mer set, in partition order.

Staging per pass: G x n_batches x cap_bp slots, cap_bp = a statistical
bound on one partition's share of a batch (mean + 8 sigma + 64).  A batch
whose partition holds more than cap_bp records is detected exactly (the
record just past the slice still belongs to the partition), never
dropped in silence; the count re-extracts such a partition alone with a
larger cap.

Conventions of this package: one int64 key lane (``SENTINEL`` for an
invalid slot) where the JAX package carries two uint32 lanes; the hashes
run on that key's lanes ``hi = key >> 32``, ``lo = key & 0xFFFFFFFF`` in
int64 with ``& 0xFFFFFFFF`` after each multiply (common.py), so every
valid key lands in the JAX package's partition bit for bit.  Overflow
flags are summed on the device and read back once a group; a
partition's ``n_distinct`` and ``n_kept`` in one read-back.
"""

from __future__ import annotations

import logging
from typing import Callable, List, NamedTuple

import numpy as np
import torch

from genome_assembly_tpu_torch.common import (
    HASH_A,
    HASH_B,
    LINK_HASH_A,
    LINK_HASH_B,
    MASK32,
    MMER_SENTINEL,
    SENTINEL,
    fmix32,
)
from genome_assembly_tpu_torch.ops import count as count_ops
from genome_assembly_tpu_torch.ops.minimizer import WindowRecords
from genome_assembly_tpu_torch.parity.table import HostTable

# Maximum partitions extracted per re-scan pass (the JAX package bounds
# the unrolled slices of its extraction executable with it; here it keeps
# the group plan, and so the pass count, equal to the JAX package's).
MAX_GROUP = 16

# staging budget of one count pass (both modes), the JAX package's default
GROUP_BUDGET_BYTES = 8 << 30

# the combined hash of a slot that is not valid; real hashes are clamped
# below it, so real records sort strictly before every invalid one
_NO_HASH = 0xFFFFFFFF

# third constant of the parity hash, on the k-mer's lo lane
_PARITY_HASH_C = 0x9E3779B9

_log = logging.getLogger(__name__)


def _mix_key(key: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """fmix32((hi * a) ^ (lo * b)) on the int64 key's two 32-bit lanes."""
    hi = key >> 32
    lo = key & MASK32
    return fmix32(((hi * a) & MASK32) ^ ((lo * b) & MASK32))


def _range_pid(h: torch.Tensor, partitions: int) -> torch.Tensor:
    return ((h >> 16) * partitions) >> 16


def key_partition_range(key: torch.Tensor, partitions: int) -> torch.Tensor:
    """RANGE partition id of count keys: ``floor(h_top16 * P / 2^16)``.

    Monotone in the 32-bit mixed hash, so a group of consecutive
    partitions is ONE contiguous hash interval.  Balance granularity is
    the 16-bit bucket: partitions own floor/ceil(65536 / P) buckets each.
    """
    return _range_pid(_mix_key(key, HASH_A, HASH_B), partitions)


def link_partition_range(key: torch.Tensor, partitions: int) -> torch.Tensor:
    """RANGE partition id of the link builder's boundary keys.

    Same scheme with the independent LINK_HASH constants: the 2-bit
    packing carries no length, so a T-leading k-mer and its (k-1)-mer
    suffix are the same value, and a shared hash would hand a quarter of
    the suffix records their k-mer's count partition band.
    """
    return _range_pid(_mix_key(key, LINK_HASH_A, LINK_HASH_B), partitions)


def _range_lower_bound(p: torch.Tensor, partitions: int) -> torch.Tensor:
    """Smallest 32-bit hash owned by partition p (int64 tensor of ids).

    pid(h) >= p  <=>  (h >> 16) >= ceil(p * 2^16 / P); an id >= P (the
    last group's overhang) maps to the all-ones bound, whose slice can
    only hold invalid slots.
    """
    bucket = (p * 65536 + (partitions - 1)) // partitions
    return torch.where(p >= partitions, _NO_HASH, bucket << 16)


def _extract(h, valid, lanes, fills, group, *, partitions, group_size, cap_bp):
    """Partitions [group * G, (group + 1) * G) of one batch's records.

    h: the 32-bit hash of every slot (int64); valid: the slots that hold
    a record; lanes: the record's tensors, flat, with their fill values.
    Returns ([G, cap_bp] per lane, overflow [G] bool): rows that are not
    members of the partition hold the lane's fill.

    One sort keyed on the clamped hash (invalid slots: all ones, so they
    sort last); each partition's run starts at a searchsorted bound, and
    its slice is a gather of ``start + arange(cap_bp)`` (starts stay on
    the device: nothing is read back).
    """
    n = h.shape[0]
    if cap_bp > n:
        raise ValueError(f"cap_bp {cap_bp} exceeds the {n} slots of a batch")
    comp = torch.where(valid, torch.clamp(h, max=_NO_HASH - 1), _NO_HASH)
    comp_s, order = torch.sort(comp, stable=True)
    pids = torch.arange(group_size, dtype=torch.int64, device=h.device) + group * group_size
    bounds = torch.searchsorted(comp_s, _range_lower_bound(pids, partitions))
    starts = torch.clamp(bounds, max=n - cap_bp)
    rows = starts[:, None] + torch.arange(cap_bp, dtype=torch.int64, device=h.device)

    def member(c, pid):
        return (_range_pid(c, partitions) == pid) & (c != _NO_HASH)

    mem = member(comp_s[rows], pids[:, None])
    src = order[rows]
    outs = [torch.where(mem, lane[src], fill) for lane, fill in zip(lanes, fills)]
    probe = torch.clamp(bounds + cap_bp, max=n - 1)
    ovf = member(comp_s[probe], pids) & (bounds + cap_bp < n)
    return outs, ovf


def extract_partition_range(key: torch.Tensor, group: int, *, partitions: int,
                            group_size: int, cap_bp: int):
    """Extract partitions [group * G, (group + 1) * G) of one batch's keys.

    key: flat int64 keys, SENTINEL for invalid slots.  Returns (keys
    [G, cap_bp] with non-members SENTINEL, overflows [G] bool).  A hash of
    0xFFFFFFFF is clamped to 0xFFFFFFFE (same partition) so every real
    record sorts strictly before the invalid run -- else a key whose hash
    lands on all ones could hide behind it past the overflow probe.
    """
    (keys,), ovf = _extract(
        _mix_key(key, HASH_A, HASH_B), key != SENTINEL, (key,), (SENTINEL,), group,
        partitions=partitions, group_size=group_size, cap_bp=cap_bp)
    return keys, ovf


def extract_partition_range3(key: torch.Tensor, pay: torch.Tensor, group: int, *,
                             partitions: int, group_size: int, cap_bp: int):
    """extract_partition_range under the LINK hash, with an int64 payload
    riding along (the link builder's side | state records).  Returns
    (keys [G, cap_bp], payloads [G, cap_bp], overflows [G]); non-members
    are SENTINEL in both lanes."""
    (keys, pays), ovf = _extract(
        _mix_key(key, LINK_HASH_A, LINK_HASH_B), key != SENTINEL, (key, pay),
        (SENTINEL, SENTINEL), group,
        partitions=partitions, group_size=group_size, cap_bp=cap_bp)
    return keys, pays, ovf


def _parity_hash(mmer: torch.Tensor, kmer: torch.Tensor) -> torch.Tensor:
    mm = mmer.long()
    return fmix32(((mm * HASH_A) & MASK32) ^ (((kmer >> 32) * HASH_B) & MASK32)
                  ^ (((kmer & MASK32) * _PARITY_HASH_C) & MASK32))


def extract_partition_range5(mmer, kmer, rid, stream, group: int, *,
                             partitions: int, group_size: int, cap_bp: int):
    """Parity-record RANGE extraction.

    The hash covers the whole (mmer, kmer) group key (the reference groups
    by signature bin AND k-mer): ``fmix32(mmer*A ^ hi*B ^ lo*0x9E3779B9)``.
    mmer: int32 (MMER_SENTINEL = invalid slot); kmer, rid, stream: int64.
    Returns (mmer, kmer, rid, stream) each [G, cap_bp] -- non-members hold
    MMER_SENTINEL / SENTINEL -- and overflows [G].
    """
    (mm, km, rd, st), ovf = _extract(
        _parity_hash(mmer, kmer), mmer != MMER_SENTINEL, (mmer, kmer, rid, stream),
        (MMER_SENTINEL, SENTINEL, SENTINEL, SENTINEL), group,
        partitions=partitions, group_size=group_size, cap_bp=cap_bp)
    return mm, km, rd, st, ovf


def range_group_plan(
    n_units: int, unit_records: int, *, partitions: int,
    bytes_per_record: int, budget_bytes: int = 6 << 30,
    group_size: int | None = None, sigma_scale: float = 1.0,
):
    """Shared (cap_bp, group_size) sizing for range-scheme extractions.

    cap_bp is statistical (mean + 8 sigma + 64 over the worst-balanced
    partition); group_size fits ``units x cap_bp x bytes`` staging per
    partition into the budget, clamped to [1, MAX_GROUP, partitions].

    sigma_scale inflates the deviation term for CLUSTERED records: keys
    arriving in same-partition groups of multiplicity <= M have
    sqrt(M)-larger per-partition count deviation than independent records
    (the link builder's boundary keys join in groups of <= 8).

    ``bytes_per_record`` is the JAX package's record width (8 for a count
    key, 12 for a link record, 20 for a parity record), kept so both
    packages plan the same passes; this package's records are wider.
    """
    mean = unit_records * np.ceil(65536 / partitions) / 65536
    cap_bp = min(
        unit_records,
        int(np.ceil(mean + 8.0 * sigma_scale * np.sqrt(mean))) + 64,
    )
    if group_size is None:
        staged = max(1, n_units * cap_bp * bytes_per_record)
        group_size = int(max(1, min(MAX_GROUP, budget_bytes // staged)))
    return cap_bp, min(group_size, partitions)


def stage_group(records, n_units: int, extract, g: int, *, partitions: int,
                group_size: int, cap_bp: int, dtypes):
    """One re-scan pass: partitions [g * G, (g + 1) * G) of every unit.

    records(u) -> the lanes of unit u; extract(*lanes, g, ...) -> G rows
    of cap_bp a lane (non-members hold the lane's fill) and G overflow
    flags.  Each partition's lanes are staged in one flat buffer a lane
    (n_units * cap_bp, ``dtypes``), filled unit by unit, so no
    concatenation follows and each partition's buffers can be
    let go of alone.  The flags are summed on the device and read back
    once, at the end: the pass makes ONE synchronising call of its own.
    Returns (parts: G lists of lanes, overflows: G ints).
    """
    parts = ovf_sum = None
    for u in range(n_units):
        lanes = records(u)
        if parts is None:
            device = lanes[0].device
            parts = [[torch.empty(n_units * cap_bp, dtype=dt, device=device) for dt in dtypes]
                     for _ in range(group_size)]
            ovf_sum = torch.zeros(group_size, dtype=torch.int64, device=device)
        *rows, ovf = extract(*lanes, g, partitions=partitions, group_size=group_size,
                             cap_bp=cap_bp)
        del lanes
        for r, bufs in enumerate(parts):
            for buf, lane in zip(bufs, rows):
                buf[u * cap_bp: (u + 1) * cap_bp] = lane[r]
        ovf_sum += ovf
        del rows, ovf
    return parts, ovf_sum.tolist()


def _reextract(records, n_units, p, *, extract, partitions, cap0, unit_records, what):
    """Re-extract ONE partition whose statistical staging cap overflowed.

    Sweeps the units again extracting only partition p, with the cap
    doubled until no unit overflows (a cap of a whole unit cannot).  Each
    unit's slice is compacted on the device and read back at its true
    size, so device memory stays at one unit's extraction.  Returns the
    partition's lanes, on the device of the records.
    """
    cap = cap0
    while True:
        cap = min(unit_records, max(2 * cap, 1024))
        _log.warning("%s partition %d overflowed its staging cap; "
                     "re-extracting alone at cap=%d", what, p, cap)
        pieces, overflowed = [], False
        for u in range(n_units):
            lanes = records(u)
            device = lanes[0].device
            *rows, ovf = extract(*lanes, p, partitions=partitions, group_size=1, cap_bp=cap)
            del lanes
            if bool(ovf[0]):
                overflowed = True
                break
            real = rows[0][0] != SENTINEL  # the key lane of the one partition
            pieces.append([lane[0][real].cpu() for lane in rows])
        if not overflowed or cap >= unit_records:
            return [torch.cat(lane).to(device) for lane in zip(*pieces)]


# ---------------------------------------------------------------------------
# fast mode: partitioned count
# ---------------------------------------------------------------------------


class PartitionedCount(NamedTuple):
    """Union of the partitions' pruned keys, in partition order (each
    partition's keys ascending; the sort-join link builder needs no
    global order)."""

    kmer: torch.Tensor  # [n_kept] int64 kept canonical keys (exact size)
    valid: torch.Tensor  # [n_kept] bool
    n_distinct: int
    n_kept: int
    group_size: int = 3  # partitions extracted per re-scan pass
    partitions: int = 0


def partitioned_count(
    batch_keys: Callable[[int], torch.Tensor],
    n_batches: int,
    *,
    partitions: int,
    cutoff: int,
    hybrid_sort: bool = False,
) -> PartitionedCount:
    """Count n_batches key batches in ceil(P / G) re-scan passes.

    batch_keys(i) -> flat int64 keys of batch i (SENTINEL = invalid),
    called once per pass per batch, plus once up front for the batch
    width.  Each pass extracts a group of G consecutive range partitions
    of every batch (``extract_partition_range``), then counts each
    partition with ``count_ops.count_keys`` (``hybrid_sort`` as there)
    and parks its kept keys on the host, trimmed to their true count.

    cap_bp and G come from ``range_group_plan`` (G = clamp(
    GROUP_BUDGET_BYTES // (n_batches * cap_bp * 8), 1, 16)).  A partition
    that overflowed its statistical cap in some batch is re-extracted
    alone with a larger cap AFTER the group's clean partitions (so its
    keys land later in the output, as in the JAX package): no record is
    ever dropped, and no overflow is left to report.
    """
    probe = batch_keys(0)
    batch_slots, device = int(probe.shape[0]), probe.device
    del probe
    cap_bp, G = range_group_plan(n_batches, batch_slots, partitions=partitions,
                                 bytes_per_record=8, budget_bytes=GROUP_BUDGET_BYTES)

    parked: List[np.ndarray] = []
    totals = dict(n_distinct=0, n_kept=0)

    def count_partition(keys: torch.Tensor) -> None:
        recs = WindowRecords(mmer=keys[:0].int(), kmer=keys, valid=keys != SENTINEL)
        kc = count_ops.count_keys(recs, cutoff=cutoff, hybrid_sort=hybrid_sort)
        del recs, keys
        n_distinct, n_kept = torch.stack(
            [(kc.group_start & kc.valid).sum(), kc.keep.sum()]).tolist()
        totals["n_distinct"] += n_distinct
        totals["n_kept"] += n_kept
        kept, _ = count_ops.kept_keys_sorted(kc)
        del kc
        parked.append(kept[:n_kept].cpu().numpy())

    def records(b):
        return (batch_keys(b),)

    for g in range(-(-partitions // G)):
        parts, group_overflows = stage_group(
            records, n_batches, extract_partition_range, g, partitions=partitions,
            group_size=G, cap_bp=cap_bp, dtypes=(torch.int64,))
        overflowed = []
        for r in range(G):
            p = g * G + r
            (keys,), parts[r] = parts[r], None
            if p >= partitions:
                continue
            if group_overflows[r]:
                # the staged records are incomplete: count the partition
                # after the group's clean ones, re-extracted alone
                overflowed.append(p)
                continue
            count_partition(keys)
            del keys
        del parts
        for p in overflowed:
            (keys,) = _reextract(
                records, n_batches, p, extract=extract_partition_range,
                partitions=partitions, cap0=cap_bp, unit_records=batch_slots, what="count")
            count_partition(keys)
            del keys

    kmer = torch.from_numpy(np.concatenate(parked)).to(device)
    return PartitionedCount(
        kmer=kmer,
        valid=kmer != SENTINEL,
        n_distinct=totals["n_distinct"],
        n_kept=totals["n_kept"],
        group_size=G,
        partitions=partitions,
    )


# ---------------------------------------------------------------------------
# parity mode: partitioned count with read-id and stream payloads
# ---------------------------------------------------------------------------


def _count_parity_partition(mmer, kmer, rid, stream, *, cutoff: int) -> count_ops.CountedTable:
    """Sort one partition's parity records by (mmer, kmer, stream) and
    mark its groups.  Groups are complete (all records of a (mmer, kmer)
    share its hash), so counts and the prune mask have their global
    meaning; stream order inside each group is what the replay needs."""
    order = count_ops._mmer_kmer_order(mmer, kmer, minor=stream)
    return count_ops._parity_groups(
        mmer[order], kmer[order], rid[order], stream[order], cutoff)


def _partition_groups(ct: count_ops.CountedTable, cutoff: int, with_streams: bool):
    """One counted partition's groups on the host: (mmer, kmer, count,
    first stream index (int64), flat read ids, flat streams or None),
    every group's occurrences contiguous in the flat arrays."""
    n = int(ct.valid.sum())
    lane = {name: getattr(ct, name)[:n].cpu().numpy()
            for name in ("mmer", "kmer", "read_id", "stream_idx", "group_start",
                         "count", "keep")}
    starts = np.flatnonzero(lane["keep"] if cutoff >= 0 else lane["group_start"])
    sizes = lane["count"][starts]
    off = np.zeros(len(starts) + 1, dtype=np.int64)
    np.cumsum(sizes, out=off[1:])
    rows = np.repeat(starts - off[:-1], sizes) + np.arange(off[-1], dtype=np.int64)
    return (lane["mmer"][starts].astype(np.uint32), lane["kmer"][starts],
            sizes.astype(np.int32), lane["stream_idx"][starts],
            lane["read_id"][rows].astype(np.uint32),
            lane["stream_idx"][rows].astype(np.uint32) if with_streams else None)


def partitioned_count_parity(
    batch_records: Callable[[int], tuple],
    n_batches: int,
    *,
    partitions: int,
    cutoff: int,
    with_streams: bool = False,
):
    """Out-of-core PARITY counting: the payload-carrying analogue of
    ``partitioned_count``.

    batch_records(i) -> (mmer int32, kmer int64, rid int64, stream int64)
    flat lanes of batch i (MMER_SENTINEL mmer = invalid slot), made again
    each pass.  Returns a parity ``HostTable`` holding every group (cutoff
    -1; the replay prunes with the reference's own semantics) or only the
    surviving groups (cutoff >= 0), in global first-seen order, plus
    (n_windows, batch_overflows); with ``with_streams``, (host, streams,
    n_windows, batch_overflows), streams[g] being group g's
    per-occurrence stream indices.

    Each group carries its global first-seen stream index (int64 here:
    the JAX package's uint32 lane wraps past 2^32 slots), so ordering
    across partitions is the reference's insertion order whichever pass
    counted the group.  cap_bp and G come from ``range_group_plan``
    (GROUP_BUDGET_BYTES at 20 bytes a record).  An overflow of the
    statistical cap is reported in ``batch_overflows``, not healed, as in
    the JAX package.
    """
    batch_slots = int(batch_records(0)[0].shape[0])
    cap_bp, G = range_group_plan(
        n_batches, batch_slots, partitions=partitions, bytes_per_record=20,
        budget_bytes=GROUP_BUDGET_BYTES)

    groups = []
    windows = []
    batch_overflows = 0

    def first_pass(b):
        """batch_records that also sums the valid windows (on the device)."""
        lanes = batch_records(b)
        windows.append((lanes[0] != MMER_SENTINEL).sum())
        return lanes

    for g in range(-(-partitions // G)):
        parts, group_overflows = stage_group(
            first_pass if g == 0 else batch_records, n_batches, extract_partition_range5, g,
            partitions=partitions, group_size=G, cap_bp=cap_bp,
            dtypes=(torch.int32, torch.int64, torch.int64, torch.int64))
        for r in range(G):
            p = g * G + r
            lanes, parts[r] = parts[r], None
            if p >= partitions:
                continue
            batch_overflows += group_overflows[r]
            ct = _count_parity_partition(*lanes, cutoff=cutoff)
            del lanes
            groups.append(_partition_groups(ct, cutoff, with_streams))
            del ct
        del parts
    n_windows = int(torch.stack(windows).sum())

    mmer, kmer, count, first = (np.concatenate([p[j] for p in groups]) for j in range(4))
    flat_ids = np.concatenate([p[4] for p in groups])
    sizes = count.astype(np.int64)
    order = np.argsort(first, kind="stable")
    host = HostTable(
        mmer=mmer[order],
        kmer=kmer[order],
        count=count[order],
        first_seen=first[order].astype(np.uint32),
        read_ids=_regroup(flat_ids, sizes, order),
    )
    if with_streams:
        streams = _regroup(np.concatenate([p[5] for p in groups]), sizes, order)
        return host, streams, n_windows, batch_overflows
    return host, n_windows, batch_overflows


def _regroup(flat: np.ndarray, sizes: np.ndarray, order: np.ndarray) -> List[np.ndarray]:
    """Group i's slice of ``flat`` (groups back to back, ``sizes`` long),
    for i in ``order``."""
    off = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(sizes, out=off[1:])
    lens = sizes[order]
    rows = np.repeat(off[:-1][order], lens) + (
        np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(np.cumsum(lens) - lens, lens))
    return np.split(flat[rows], np.cumsum(lens)[:-1]) if len(lens) else []


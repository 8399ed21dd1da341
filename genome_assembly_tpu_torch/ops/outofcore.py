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
The super-k-mer count (``partitioned_count_super``) stages 24-byte records
of about ten windows each, partitioned by minimizer in ragged groups of any
partition ids, and expands each partition back to windows before its count.
Both fast counts can bank each partition in a checkpoint directory
(``_PartStore``, the JAX package's files) and count a worker's share of
the partitions.

All duplicates of a key share its hash, so a partition's counts are
complete and partitions are disjoint: the union of the partitions' kept
keys IS the pruned k-mer set, in partition order.

Staging per pass: G x n_batches x cap_bp slots, cap_bp = a statistical
bound on one partition's share of a batch (mean + 8 sigma + 64).  A batch
whose partition holds more than cap_bp records is detected exactly (the
record just past the slice still belongs to the partition), never
dropped in silence; the count re-extracts such a partition alone with a
larger cap.

Steps of a pass are spans of the run in progress (``utils/profiling``):
``extract`` (each unit's extraction into the staging buffers, and the
pass's one read-back of its overflow flags), ``partition`` (a partition's
count, its read-back included) and ``reextract``; the kept keys parked on
the host count as ``d2h_bytes``, and those sent back to the device as
``h2d_bytes``.

Conventions of this package: one int64 key lane (``SENTINEL`` for an
invalid slot) where the JAX package carries two uint32 lanes; the hashes
run on that key's lanes ``hi = key >> 32``, ``lo = key & 0xFFFFFFFF`` in
int64 with ``& 0xFFFFFFFF`` after each multiply (common.py), so every
valid key lands in the JAX package's partition bit for bit.  Overflow
flags are summed on the device and read back once a group; a
partition's ``n_distinct`` and ``n_kept`` in one read-back.
"""

from __future__ import annotations

import json
import logging
import os
import pathlib
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
from genome_assembly_tpu_torch.utils import profiling

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


def _group_pids(group, group_size, device) -> torch.Tensor:
    """The partition ids a group extracts: ``group`` itself when it is a
    tensor of ids (any ids, in any order), else the consecutive ids
    [group * G, (group + 1) * G).  An id >= partitions is inert: its slice
    starts at the invalid run and nothing in it is a member."""
    if isinstance(group, torch.Tensor):
        return group
    return torch.arange(group_size, dtype=torch.int64, device=device) + group * group_size


def _extract(h, valid, lanes, fills, group, *, partitions, group_size, cap_bp):
    """The partitions of ``group`` (``_group_pids``) of one batch's records.

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
    pids = _group_pids(group, group_size, h.device)
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


def stage_group(records, n_units: int, extract, group, *, partitions: int,
                group_size: int | None = None, cap_bp: int, dtypes, on_unit=None):
    """One re-scan pass: the partitions of ``group`` from every unit.

    group: a group index g (the partitions [g * G, (g + 1) * G), G =
    ``group_size``) or a list of partition ids (G = its length; copied to
    the device once a pass).  records(u) -> the lanes of unit u;
    extract(*lanes, group, ...) -> G rows of cap_bp a lane (non-members
    hold the lane's fill) and G overflow flags.  Each partition's lanes
    are staged in one flat buffer a lane (n_units * cap_bp, ``dtypes``),
    filled unit by unit, so no concatenation follows and each partition's
    buffers can be let go of alone.  The flags are summed on the device and
    read back once, at the end: the pass makes ONE synchronising call of
    its own.  ``on_unit(u + 1)`` runs after each unit's extraction is
    queued.  Returns (parts: G lists of lanes, overflows: G ints).
    """
    if not isinstance(group, (int, np.integer)):
        group = np.asarray(group, dtype=np.int64)
        group_size = len(group)
    parts = ovf_sum = pids = None
    for u in range(n_units):
        lanes = records(u)
        with profiling.span("extract"):
            if parts is None:
                device = lanes[0].device
                pids = int(group) if isinstance(group, (int, np.integer)) else \
                    torch.from_numpy(group).to(device)
                parts = [[torch.empty(n_units * cap_bp, dtype=dt, device=device)
                          for dt in dtypes] for _ in range(group_size)]
                ovf_sum = torch.zeros(group_size, dtype=torch.int64, device=device)
            *rows, ovf = extract(*lanes, pids, partitions=partitions, group_size=group_size,
                                 cap_bp=cap_bp)
            del lanes
            for r, bufs in enumerate(parts):
                for buf, lane in zip(bufs, rows):
                    buf[u * cap_bp: (u + 1) * cap_bp] = lane[r]
            ovf_sum += ovf
            del rows, ovf
        if on_unit is not None:
            on_unit(u + 1)
    with profiling.span("extract"):
        profiling.count("d2h_bytes", ovf_sum.nbytes)
        return parts, ovf_sum.tolist()


def _reextract(records, n_units, p, *, extract, partitions, cap0, unit_records, what,
               fill=SENTINEL):
    """Re-extract ONE partition whose statistical staging cap overflowed.

    Sweeps the units again extracting only partition p, with the cap
    doubled until no unit overflows (a cap of a whole unit cannot).  Each
    unit's slice is compacted on the device and read back at its true
    size, so device memory stays at one unit's extraction.  ``fill`` is the
    first lane's value at a non-member row.  Returns the partition's lanes,
    on the device of the records.
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
            real = rows[0][0] != fill  # the first lane of the one partition
            pieces.append([lane[0][real].cpu() for lane in rows])
            profiling.count("d2h_bytes", sum(x.nbytes for x in pieces[-1]))
        if not overflowed or cap >= unit_records:
            lanes = [torch.cat(lane) for lane in zip(*pieces)]
            profiling.count("h2d_bytes", sum(x.nbytes for x in lanes))
            return [lane.to(device) for lane in lanes]


# ---------------------------------------------------------------------------
# fast mode: partitioned count, and its checkpoints
# ---------------------------------------------------------------------------


class PartitionedCount(NamedTuple):
    """Union of the partitions' pruned keys, in partition order (each
    partition's keys ascending -- subrange by subrange for a super
    partition counted in subranges; the sort-join link builder needs no
    global order).  With ``return_host`` kmer and valid are numpy arrays."""

    kmer: torch.Tensor  # [n_kept] int64 kept canonical keys (exact size)
    valid: torch.Tensor  # [n_kept] bool
    n_distinct: int
    n_kept: int
    group_size: int = 3  # partitions a pass (super: the widest group's width bucket)
    partitions: int = 0
    passes: int = 0  # re-scan passes this call made (a resumed group makes none)
    expand_chunks: int = 0  # super records: chunks expanded (each one K1 launch)


class _PartStore:
    """The ``part_<p>.npz`` checkpoints of a partitioned count, in the JAX
    package's format (written uncompressed, which the JAX package's
    ``np.load`` reads as well): ``meta.json`` holds the run's fingerprint (a
    directory written by another configuration is refused), each part
    file its partition's kept keys as uint32 ``khi``/``klo`` lanes with
    int64 ``n_distinct``, ``n_kept``, ``batch_overflows`` -- written to a
    temporary name and renamed.  A part is reused only if its pass saw no
    overflow.  Partition contents depend on the fingerprinted parameters
    alone (not on the group widths or caps), so a directory survives a
    change of staging budget, and a directory written by either package
    resumes in the other."""

    META = "meta.json"
    KIND = ""

    def __init__(self, checkpoint_dir, fingerprint: dict):
        self.dir = pathlib.Path(checkpoint_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        meta_path = self.dir / self.META
        if meta_path.exists():
            old = json.loads(meta_path.read_text())
            if old != fingerprint:
                raise ValueError(
                    f"checkpoint_dir {self.dir} was written by a different "
                    f"{self.KIND}configuration: {old} != {fingerprint}; use a fresh directory")
        else:
            meta_path.write_text(json.dumps(fingerprint))

    @classmethod
    def open(cls, checkpoint_dir, dataset_tag, fingerprint: dict):
        """The store of checkpoint_dir (None without one); ``dataset_tag``,
        when given, joins the fingerprint as its ``dataset``."""
        if checkpoint_dir is None:
            return None
        if dataset_tag is not None:
            fingerprint = {**fingerprint, "dataset": dataset_tag}
        return cls(checkpoint_dir, fingerprint)

    def usable(self, p: int) -> bool:
        path = self.dir / f"part_{p}.npz"
        return path.exists() and int(np.load(path)["batch_overflows"]) == 0

    def load(self, p: int):
        """(kept keys int64 numpy, n_distinct, n_kept)."""
        saved = np.load(self.dir / f"part_{p}.npz")
        key = (saved["khi"].astype(np.int64) << 32) | saved["klo"].astype(np.int64)
        return key, int(saved["n_distinct"]), int(saved["n_kept"])

    def save(self, p: int, key: np.ndarray, n_distinct: int, n_kept: int) -> None:
        # uncompressed (np.load reads both forms): zlib took about 1 s a
        # partition of near-random keys for a few percent
        tmp = self.dir / f"part_{p}.tmp.npz"
        np.savez(
            tmp, khi=(key >> 32).astype(np.uint32), klo=(key & MASK32).astype(np.uint32),
            n_distinct=np.int64(n_distinct), n_kept=np.int64(n_kept),
            batch_overflows=np.int64(0))
        os.replace(tmp, self.dir / f"part_{p}.npz")


def _owned_range(only_partitions, store, partitions: int):
    """(lo, hi) of ``only_partitions`` after the JAX package's checks."""
    if only_partitions is None:
        return None
    if store is None:
        raise ValueError("only_partitions requires checkpoint_dir (partition "
                         "results flow through the shared part_<p>.npz files)")
    own_lo, own_hi = int(only_partitions[0]), int(only_partitions[1])
    if own_lo >= min(own_hi, partitions):
        raise ValueError(
            f"only_partitions=({own_lo}, {own_hi}) owns nothing: the run has "
            f"{partitions} partitions (auto-sized; check the worker's range "
            "against the merge run's partition count)")
    return own_lo, own_hi


class _KeptKeys:
    """The kept keys of a partitioned count as they come, partition by
    partition, on the host; each counted partition is saved to the store
    (when there is one)."""

    def __init__(self, store):
        self.store = store
        self.parts: List[np.ndarray] = []
        self.n_distinct = self.n_kept = 0

    def add(self, key: np.ndarray, n_distinct: int, n_kept: int) -> None:
        self.parts.append(key)
        self.n_distinct += n_distinct
        self.n_kept += n_kept

    def load(self, p: int) -> None:
        self.add(*self.store.load(p))

    def counted(self, p: int, key: np.ndarray, n_distinct: int, n_kept: int) -> None:
        self.add(key, n_distinct, n_kept)
        if self.store is not None:
            self.store.save(p, key, n_distinct, n_kept)

    def result(self, device, return_host: bool, **fields) -> PartitionedCount:
        key = np.concatenate(self.parts) if self.parts else np.zeros(0, np.int64)
        if not return_host:
            profiling.count("h2d_bytes", key.nbytes)
        kmer = key if return_host else torch.from_numpy(key).to(device)
        return PartitionedCount(kmer=kmer, valid=kmer != SENTINEL, n_distinct=self.n_distinct,
                                n_kept=self.n_kept, **fields)


def _progress(on_progress, g: int, n_groups: int, n_units: int):
    if on_progress is None:
        return None
    return lambda done: on_progress(g, n_groups, done, n_units)


def _count_kept(keys: torch.Tensor, *, cutoff: int, hybrid_sort: bool = False):
    """(kept keys, ascending, int64 numpy; n_distinct; n_kept) of one set
    of keys (SENTINEL = none); the two counters in one read-back."""
    recs = WindowRecords(mmer=keys[:0].int(), kmer=keys, valid=keys != SENTINEL)
    kc = count_ops.count_keys(recs, cutoff=cutoff, hybrid_sort=hybrid_sort)
    del recs, keys
    both = torch.stack([(kc.group_start & kc.valid).sum(), kc.keep.sum()])
    profiling.count("d2h_bytes", both.nbytes)
    n_distinct, n_kept = both.tolist()
    kept, _ = count_ops.kept_keys_sorted(kc)
    del kc
    kept = kept[:n_kept].cpu().numpy()
    profiling.count("d2h_bytes", kept.nbytes)
    return kept, n_distinct, n_kept


def _count_groups(groups, records, n_units, extract, *, partitions, unit_records, dtypes,
                  what, fill, store, owned_range, out, count_partition, on_progress):
    """The group loop of both fast counts; returns the re-scan passes made.

    groups: (what ``stage_group`` takes -- a group index or a list of ids --,
    the partition ids it stages in row order, the staging cap).  A group
    whose owned partitions are all in the store is loaded, with no pass.
    Otherwise one pass stages it; each owned partition is loaded from the
    store, or counted (``count_partition(p, lanes)``), or -- when its cap
    overflowed in some unit -- re-extracted alone and counted after the
    group's others, so no record is dropped and the order is the JAX
    package's.
    """
    passes = 0
    for g, (group, pids, cap) in enumerate(groups):
        owned = [p for p in pids if p < partitions
                 and (owned_range is None or owned_range[0] <= p < owned_range[1])]
        if not owned:
            continue
        if store is not None and all(store.usable(p) for p in owned):
            for p in owned:
                out.load(p)
            continue
        parts, group_overflows = stage_group(
            records, n_units, extract, group, partitions=partitions, group_size=len(pids),
            cap_bp=cap, dtypes=dtypes, on_unit=_progress(on_progress, g, len(groups), n_units))
        passes += 1
        overflowed = []
        for r, p in enumerate(pids):
            lanes, parts[r] = parts[r], None
            if p not in owned:
                continue
            if store is not None and store.usable(p):
                out.load(p)
            elif group_overflows[r]:
                overflowed.append(p)
            else:
                with profiling.span("partition"):
                    count_partition(p, lanes)
            del lanes
        del parts
        for p in overflowed:
            with profiling.span("reextract"):
                lanes = _reextract(
                    records, n_units, p, extract=extract, partitions=partitions, cap0=cap,
                    unit_records=unit_records, what=what, fill=fill)
            with profiling.span("partition"):
                count_partition(p, lanes)
            del lanes
    return passes


def partitioned_count(
    batch_keys: Callable[[int], torch.Tensor],
    n_batches: int,
    *,
    partitions: int,
    cutoff: int,
    hybrid_sort: bool = False,
    group_budget_bytes: int = GROUP_BUDGET_BYTES,
    checkpoint_dir: str | None = None,
    return_host: bool = False,
    only_partitions: tuple | None = None,
    on_progress: Callable[[int, int, int, int], None] | None = None,
    dataset_tag: str | None = None,
) -> PartitionedCount:
    """Count n_batches key batches in ceil(P / G) re-scan passes.

    batch_keys(i) -> flat int64 keys of batch i (SENTINEL = invalid),
    called once per pass per batch, plus once up front for the batch
    width.  Each pass extracts a group of G consecutive range partitions
    of every batch (``extract_partition_range``), then counts each
    partition with ``count_ops.count_keys`` (``hybrid_sort`` as there)
    and parks its kept keys on the host, trimmed to their true count.

    cap_bp and G come from ``range_group_plan`` (G = clamp(
    group_budget_bytes // (n_batches * cap_bp * 8), 1, 16)).  A partition
    that overflowed its statistical cap in some batch is re-extracted
    alone with a larger cap AFTER the group's clean partitions (so its
    keys land later in the output, as in the JAX package): no record is
    ever dropped, and no overflow is left to report.

    checkpoint_dir: each counted partition's kept keys land in
    ``part_<p>.npz`` there (``_PartStore``) and are loaded instead of
    counted on a later call; a group whose partitions are all there makes
    no pass.  The fingerprint is (partitions, cutoff, n_batches,
    batch_slots) and ``dataset_tag`` when given (a caller whose batch
    content can differ under the same geometry must tag).
    only_partitions=(lo, hi): count only the partitions in [lo, hi) into
    checkpoint_dir (a worker's share; a later call without it merges every
    partition with no pass); a group that straddles the range stages all
    of it but counts and saves only the owned ones.  return_host: the kept
    keys come back as numpy (they were parked on the host anyway).
    on_progress(group, n_groups, batches_done, n_batches) runs after each
    batch's extraction is queued.
    """
    probe = batch_keys(0)
    batch_slots, device = int(probe.shape[0]), probe.device
    del probe
    cap_bp, G = range_group_plan(n_batches, batch_slots, partitions=partitions,
                                 bytes_per_record=8, budget_bytes=group_budget_bytes)
    store = _PartStore.open(checkpoint_dir, dataset_tag, {
        "format": 5, "scheme": "range16", "partitions": partitions, "cutoff": cutoff,
        "n_batches": n_batches, "batch_slots": batch_slots})
    owned_range = _owned_range(only_partitions, store, partitions)
    out = _KeptKeys(store)

    def count_partition(p, lanes):
        out.counted(p, *_count_kept(lanes[0], cutoff=cutoff, hybrid_sort=hybrid_sort))

    def records(b):
        return (batch_keys(b),)

    groups = [(g, list(range(g * G, (g + 1) * G)), cap_bp) for g in range(-(-partitions // G))]
    passes = _count_groups(
        groups, records, n_batches, extract_partition_range, partitions=partitions,
        unit_records=batch_slots, dtypes=(torch.int64,), what="count", fill=SENTINEL,
        store=store, owned_range=owned_range, out=out, count_partition=count_partition,
        on_progress=on_progress)
    return out.result(device, return_host, group_size=G, partitions=partitions, passes=passes)


# ---------------------------------------------------------------------------
# fast mode: the partitioned count over super-k-mer records
# ---------------------------------------------------------------------------

# the widest group of the super count (a sanity rail, as in the JAX package)
SUPER_MAX_GROUP = 128

# Expanded window slots above which a super partition is counted by key-hash
# subranges.  A module constant, read at call time: tests and chip_smoke.py
# patch it to force small partitions through the subrange path.
SUB_COUNT_SLOTS = 192 << 20

# The super count's auto-sized partitions hold about this many expanded
# window slots (the count sort's working set), and a partition expands
# EXPAND_CHUNK records a K1 launch: the JAX package's defaults, read at call
# time (tests patch them to small sizes).
EXPAND_SLOTS_BUDGET = 128 << 20
EXPAND_CHUNK = 1 << 20


def _mmer_hash(mmer: torch.Tensor) -> torch.Tensor:
    """fmix32((mm * HASH_A) ^ (mm * HASH_B)): both lanes of the mixer are
    the m-mer (int32) itself."""
    mm = mmer.long()
    return fmix32(((mm * HASH_A) & MASK32) ^ ((mm * HASH_B) & MASK32))


def extract_partition_range_super(mmer, slen, w0, w1, group, *, partitions: int,
                                  cap_bp: int, group_size: int | None = None):
    """RANGE extraction of super-k-mer records, partitioned by MINIMIZER.

    All of a canonical k-mer's occurrences share its minimizer, so hashing
    the mmer lane keeps k-mer groups complete per partition.  group: a
    group index (with group_size) or a tensor of partition ids -- any ids:
    each slices its own hash interval.  Returns the four lanes [G, cap_bp]
    (non-members hold ``superkmer.FILLS``) and overflows [G].
    """
    from genome_assembly_tpu_torch.ops import superkmer

    outs, ovf = _extract(
        _mmer_hash(mmer), mmer != MMER_SENTINEL, (mmer, slen, w0, w1), superkmer.FILLS,
        group, partitions=partitions, group_size=group_size, cap_bp=cap_bp)
    return (*outs, ovf)


def _quarter_pow2(v) -> int:
    """v rounded up to {1, 1.25, 1.5, 1.75} x 2^e."""
    v = max(int(v), 1)
    e = 1 << max(v.bit_length() - 3, 0)
    return -(-v // e) * e


def super_group_plan(loads: np.ndarray, n_batches: int, batch_slots: int, *,
                     group_budget_bytes: int, expand_slots_budget: int):
    """The JAX package's ragged groups: [(sorted partition ids, cap, width
    bucket), ...].

    Per-partition caps come from the probe batch's histogram ``loads``
    (1.25 x load + 8 sigma + 64), groups are packed from the load-sorted
    order (similar loads share a group), a group's cap is its largest
    member's rounded up to a quarter power of two, and its width the
    largest of 128, 64, ... 1 whose staging (24 B a record) fits the budget
    less the expansion's working set (4 x expand_slots_budget x 8 B).
    """
    partitions = len(loads)
    caps_p = np.minimum(
        batch_slots,
        np.ceil(1.25 * loads + 8.0 * np.sqrt(np.maximum(loads, 1))).astype(np.int64) + 64)
    resv = 4 * expand_slots_budget * 8
    stage_budget = max(group_budget_bytes - resv, group_budget_bytes // 8)
    order = np.argsort(caps_p, kind="stable").astype(np.int64)
    groups = []
    lo = 0
    while lo < partitions:
        for width_bucket in (128, 64, 32, 16, 8, 4, 2, 1):
            if width_bucket > SUPER_MAX_GROUP:
                continue
            width = min(width_bucket, partitions - lo)
            cap_g = _quarter_pow2(caps_p[order[lo: lo + width]].max())
            if width_bucket == 1 or n_batches * cap_g * 24 * width_bucket <= stage_budget:
                break
        groups.append((np.sort(order[lo: lo + width]), min(cap_g, batch_slots), width_bucket))
        lo += width
    return groups


def _expanded_keys(lanes, lo: int, hi: int, *, k: int, m: int) -> torch.Tensor:
    """The valid keys of records [lo, hi) expanded (one K1 launch)."""
    from genome_assembly_tpu_torch.ops import superkmer

    key = superkmer.expand_records(*(x[lo:hi] for x in lanes), k=k, m=m)
    return key[key != SENTINEL]


def _count_super_partition(lanes, *, cutoff: int, k: int, m: int, chunk: int):
    """Expand one partition's records chunk by chunk and count the windows.

    The real records are compacted first (the staged layout is mostly
    fill) and only they expand, ``chunk`` records a K1 launch.  A partition
    whose expansion would pass ``SUB_COUNT_SLOTS`` -- by the JAX package's
    measure: its occupied chunks rounded up to a power of two, times
    chunk x S_CAP -- is counted by key-hash subranges instead
    (``_count_super_partition_subranges``), exactly where the JAX package
    does, so the keys come out in the same order.  Returns (kept keys
    numpy, n_distinct, n_kept, chunks expanded).
    """
    from genome_assembly_tpu_torch.ops import superkmer

    n = lanes[0].shape[0]
    real = lanes[0] != MMER_SENTINEL
    lanes = [x[real] for x in lanes]
    n_real = lanes[0].shape[0]
    need = max(1, -(-n_real // chunk))
    n_chunks = min(1 << (need - 1).bit_length(), -(-n // chunk))
    if n_chunks * chunk * superkmer.S_CAP > SUB_COUNT_SLOTS:
        return _count_super_partition_subranges(
            lanes, cutoff=cutoff, k=k, m=m, chunk=chunk, n_chunks=n_chunks)
    pieces = [_expanded_keys(lanes, lo, lo + chunk, k=k, m=m) for lo in range(0, n_real, chunk)]
    keys = torch.cat(pieces) if pieces else lanes[1].new_zeros(0).long()
    return (*_count_kept(keys, cutoff=cutoff), len(pieces))


def _count_super_partition_subranges(lanes, *, cutoff: int, k: int, m: int, chunk: int,
                                     n_chunks: int):
    """Count ONE oversized super partition in key-hash subranges.

    n_sub = max(2, ceil(n_chunks x chunk x S_CAP / SUB_COUNT_SLOTS)), the
    JAX package's.  For each subrange every chunk expands again, the
    windows whose key hashes (LINK constants, independent of the minimizer
    hash) into the subrange are kept, and the subrange is counted alone:
    all windows of one k-mer share its key, so subrange counts are exact
    and their kept sets disjoint.  The keys come out subrange by subrange,
    each ascending.  (The JAX package bounds each chunk's share with a
    retain prefix and retries on overflow; the kept keys are the same.)
    """
    from genome_assembly_tpu_torch.ops import superkmer

    n_sub = max(2, -(-(n_chunks * chunk * superkmer.S_CAP) // SUB_COUNT_SLOTS))
    n_real = lanes[0].shape[0]
    kept, n_distinct, n_kept, expanded = [], 0, 0, 0
    for sub in range(n_sub):
        pieces = []
        for lo in range(0, n_real, chunk):
            key = _expanded_keys(lanes, lo, lo + chunk, k=k, m=m)
            expanded += 1
            pieces.append(key[_range_pid(_mix_key(key, LINK_HASH_A, LINK_HASH_B), n_sub) == sub])
            del key
        keys = torch.cat(pieces) if pieces else lanes[1].new_zeros(0).long()
        del pieces
        key_s, d, kc = _count_kept(keys, cutoff=cutoff)
        kept.append(key_s)
        n_distinct += d
        n_kept += kc
    return np.concatenate(kept), n_distinct, n_kept, expanded


def partitioned_count_super(
    batch_super: Callable[[int], tuple],
    n_batches: int,
    *,
    k: int,
    m: int,
    partitions: int = 0,
    cutoff: int,
    group_budget_bytes: int = GROUP_BUDGET_BYTES,
    checkpoint_dir: str | None = None,
    return_host: bool = False,
    only_partitions: tuple | None = None,
    on_progress: Callable[[int, int, int, int], None] | None = None,
    dataset_tag: str | None = None,
) -> PartitionedCount:
    """Out-of-core counting over SUPER-K-MER records (ops/superkmer.py).

    batch_super(i) -> the four flat record lanes of batch i
    (``superkmer.super_records``), made again each pass.  A record costs
    24 B for about ten windows where the plain count stages 8 B a window,
    so a pass extracts several times more partitions within one budget.
    Partitions hash the MINIMIZER (``extract_partition_range_super``), and
    each partition's records expand back to windows chunk by chunk
    (``EXPAND_CHUNK`` records a K1 launch) before the count.

    partitions=0 sizes them so one partition's expanded window slots fit
    ``EXPAND_SLOTS_BUDGET``, from the probe batch's record count.  Groups
    are the JAX package's ragged groups (``super_group_plan``), each
    partition's staging cap from the probe batch's histogram; a partition
    that overflowed its cap is re-extracted alone after its group's clean
    ones.  The keys come out group by group, each group's partitions in
    ascending id order, each partition ascending (by subrange when it is
    counted by subranges) -- the JAX package's list element for element.

    checkpoint_dir, only_partitions, return_host, on_progress and
    dataset_tag: as in ``partitioned_count`` (fingerprint scheme
    ``super-range16`` with k, m and S_CAP).
    """
    from genome_assembly_tpu_torch.ops import superkmer

    expand_slots_budget, expand_chunk = EXPAND_SLOTS_BUDGET, EXPAND_CHUNK
    probe = batch_super(0)
    batch_slots, device = int(probe[0].shape[0]), probe[0].device
    mm0 = probe[0][probe[0] != MMER_SENTINEL]
    del probe
    n_rec0 = int(mm0.shape[0])
    if partitions == 0:
        total_recs = max(n_rec0 * n_batches, 1)
        per_part = max(expand_slots_budget // superkmer.S_CAP, 1)
        partitions = int(np.ceil(1.1 * total_recs / per_part))
    partitions = max(partitions, 1)
    if n_rec0:
        loads = torch.bincount(_range_pid(_mmer_hash(mm0), partitions),
                               minlength=partitions).cpu().numpy()
    else:
        loads = np.ones(partitions, np.int64)
    del mm0
    groups = super_group_plan(loads, n_batches, batch_slots,
                              group_budget_bytes=group_budget_bytes,
                              expand_slots_budget=expand_slots_budget)

    store = _PartStore.open(checkpoint_dir, dataset_tag, {
        "format": 5, "scheme": "super-range16", "partitions": partitions, "cutoff": cutoff,
        "k": k, "m": m, "s_cap": superkmer.S_CAP, "n_batches": n_batches,
        "batch_slots": batch_slots})
    owned_range = _owned_range(only_partitions, store, partitions)
    out = _KeptKeys(store)
    expanded = 0

    def count_partition(p, lanes):
        nonlocal expanded
        key, n_distinct, n_kept, chunks = _count_super_partition(
            lanes, cutoff=cutoff, k=k, m=m, chunk=expand_chunk)
        expanded += chunks
        out.counted(p, key, n_distinct, n_kept)

    passes = _count_groups(
        [(pids, [int(p) for p in pids], cap) for pids, cap, _ in groups], batch_super,
        n_batches, extract_partition_range_super, partitions=partitions,
        unit_records=batch_slots, dtypes=superkmer.DTYPES, what="super count",
        fill=MMER_SENTINEL, store=store, owned_range=owned_range, out=out,
        count_partition=count_partition, on_progress=on_progress)
    return out.result(device, return_host, group_size=max(b for _, _, b in groups),
                      partitions=partitions, passes=passes, expand_chunks=expanded)


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
    """One counted partition's groups on the host: (mmer uint32, kmer
    int64, count int32, first stream index int64, flat read ids uint32,
    flat stream indices int64 or None), every group's occurrences
    contiguous in the flat arrays."""
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
            lane["stream_idx"][rows] if with_streams else None)


class _ParityStore(_PartStore):
    """The checkpoints of a partitioned parity count, in the JAX package's
    format: ``meta_parity.json`` (the fingerprint; another configuration's
    directory is refused), ``windows_parity.npy`` (the valid windows, an
    int64, written after the first pass) and per partition
    ``part_<p>_parity.npz`` (uint32 ``mmer``, ``khi``, ``klo``, int32
    ``count``, ``first`` (below), uint32 ``flat_ids``, ``flat_streams`` when
    the run kept streams, int64 ``overflows``: the staging overflows of the
    pass that counted it, reported again on every load).  ``first`` and
    ``flat_streams`` are uint32 when every value fits (the JAX package's
    lane) and int64 past 2^32 - 1, where the JAX package's own lane wraps;
    read back as int64.  A part saved without streams is not used by a run
    that needs them (that partition is counted again)."""

    META = "meta_parity.json"
    KIND = "parity "

    def _path(self, p: int) -> pathlib.Path:
        return self.dir / f"part_{p}_parity.npz"

    def usable(self, p: int, with_streams: bool = False) -> bool:
        path = self._path(p)
        if not path.exists():
            return False
        if not with_streams:
            return True
        with np.load(path) as saved:
            return "flat_streams" in saved.files

    def load(self, p: int, with_streams: bool = False):
        """(the partition's groups as ``_partition_groups`` gives them,
        its overflows)."""
        from genome_assembly_tpu_torch.convert import lanes_to_key

        with np.load(self._path(p)) as saved:
            streams = saved["flat_streams"].astype(np.int64) if with_streams else None
            return ((saved["mmer"].astype(np.uint32), lanes_to_key(saved["khi"], saved["klo"]),
                     saved["count"].astype(np.int32), saved["first"].astype(np.int64),
                     saved["flat_ids"].astype(np.uint32), streams),
                    int(saved["overflows"]))

    def save(self, p: int, part, overflows: int) -> None:
        from genome_assembly_tpu_torch.convert import key_to_lanes
        from genome_assembly_tpu_torch.utils.checkpoint import fits_uint32

        mmer, kmer, count, first, flat_ids, flat_streams = part
        khi, klo = key_to_lanes(kmer)
        extra = {} if flat_streams is None else {"flat_streams": fits_uint32(flat_streams)}
        tmp = self.dir / f"part_{p}_parity.tmp.npz"
        # uncompressed, as _PartStore's (the JAX package compresses; np.load
        # reads both): with zlib a fresh 2 Mb x 50x run took 31.8 s, without
        # 9.8 s (chip_smoke.py surfaces_e2e, NVIDIA H100 80GB HBM3, 700 W)
        np.savez(tmp, mmer=mmer, khi=khi, klo=klo, count=count, first=fits_uint32(first),
                 flat_ids=flat_ids, overflows=np.int64(overflows), **extra)
        os.replace(tmp, self._path(p))

    def windows(self) -> int:
        return int(np.load(self.dir / "windows_parity.npy"))

    def save_windows(self, n_windows: int) -> None:
        np.save(self.dir / "windows_parity.npy", np.int64(n_windows))


def partitioned_count_parity(
    batch_records: Callable[[int], tuple],
    n_batches: int,
    *,
    partitions: int,
    cutoff: int,
    with_streams: bool = False,
    checkpoint_dir: str | None = None,
    dataset_tag: str | None = None,
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

    checkpoint_dir: each counted partition's groups land in
    ``part_<p>_parity.npz`` there (``_ParityStore``, the JAX package's
    files) and are loaded instead of counted on a later call; a group whose
    partitions are all there makes no pass.  The fingerprint is (partitions,
    cutoff, n_batches, batch_slots) and ``dataset_tag`` when given; a
    directory of another fingerprint raises ``ValueError``.
    """
    batch_slots = int(batch_records(0)[0].shape[0])
    cap_bp, G = range_group_plan(
        n_batches, batch_slots, partitions=partitions, bytes_per_record=20,
        budget_bytes=GROUP_BUDGET_BYTES)
    store = _ParityStore.open(checkpoint_dir, dataset_tag, {
        "format": 2, "scheme": "range16", "mode": "parity", "partitions": partitions,
        "cutoff": cutoff, "n_batches": n_batches, "batch_slots": batch_slots})

    groups = []
    windows = []
    n_windows = None
    batch_overflows = 0

    def first_pass(b):
        """batch_records that also sums the valid windows (on the device)."""
        lanes = batch_records(b)
        windows.append((lanes[0] != MMER_SENTINEL).sum())
        return lanes

    def usable(p):
        return store is not None and store.usable(p, with_streams)

    for g in range(-(-partitions // G)):
        pids = range(g * G, min((g + 1) * G, partitions))
        if all(usable(p) for p in pids):
            for p in pids:
                part, overflows = store.load(p, with_streams)
                groups.append(part)
                batch_overflows += overflows
            if g == 0:
                n_windows = store.windows()
            continue
        parts, group_overflows = stage_group(
            first_pass if g == 0 else batch_records, n_batches, extract_partition_range5, g,
            partitions=partitions, group_size=G, cap_bp=cap_bp,
            dtypes=(torch.int32, torch.int64, torch.int64, torch.int64))
        if g == 0:
            n_windows = torch.stack(windows).sum()
            if store is not None:
                store.save_windows(int(n_windows))
        for r in range(G):
            p = g * G + r
            lanes, parts[r] = parts[r], None
            if p >= partitions:
                continue
            if usable(p):
                part, overflows = store.load(p, with_streams)
            else:
                ct = _count_parity_partition(*lanes, cutoff=cutoff)
                del lanes
                part, overflows = _partition_groups(ct, cutoff, with_streams), group_overflows[r]
                del ct
                if store is not None:
                    store.save(p, part, overflows)
            groups.append(part)
            batch_overflows += overflows
        del parts
    n_windows = int(n_windows)

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
        streams = _regroup(np.concatenate([p[5] for p in groups]).astype(np.uint32), sizes,
                           order)
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


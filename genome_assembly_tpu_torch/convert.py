"""Carry data between the JAX package's conventions and this package's.

There are no weights in this system; what crosses between the two
packages is read batches, window records, key tables (fast mode's
``KeyCounts``, parity mode's ``CountedTable`` and ``HostTable``, the
mesh's ``ShardedCount``) and graphs.  The JAX
package holds a k-mer as two uint32 lanes ``(hi, lo)`` with the all-ones
pair as padding sentinel, m-mers as uint32, counts and state ids as
32-bit; this package holds one int64 key ``(hi << 32) | lo`` with int64
max as sentinel, int32 m-mers (sentinel int32 max), int64 counts and
state ids.

Everything here takes and returns numpy arrays (``*_to_torch`` return
CPU tensors built from them), so a caller hands in ``np.asarray`` of a
JAX result; this module imports neither package's framework but torch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from genome_assembly_tpu_torch.common import MMER_SENTINEL, SENTINEL
from genome_assembly_tpu_torch.io.reads import ReadBatch
from genome_assembly_tpu_torch.ops.count import CountedTable, KeyCounts
from genome_assembly_tpu_torch.ops.dbg import CompactedGraph
from genome_assembly_tpu_torch.ops.minimizer import WindowRecords
from genome_assembly_tpu_torch.parallel.shard_count import ShardedCount
from genome_assembly_tpu_torch.parity.table import HostTable

LANE_SENTINEL = np.uint32(0xFFFFFFFF)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def lanes_to_key(hi, lo) -> np.ndarray:
    """(hi, lo) uint32 lanes -> int64 keys; the all-ones pair -> SENTINEL."""
    hi = _np(hi).astype(np.uint32)
    lo = _np(lo).astype(np.uint32)
    key = ((hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)).astype(np.int64)
    return np.where((hi == LANE_SENTINEL) & (lo == LANE_SENTINEL), np.int64(SENTINEL), key)


def key_to_lanes(key) -> Tuple[np.ndarray, np.ndarray]:
    """int64 keys -> (hi, lo) uint32 lanes; SENTINEL -> the all-ones pair."""
    key = _np(key).astype(np.int64)
    sent = key == SENTINEL
    hi = np.where(sent, LANE_SENTINEL, (key >> 32).astype(np.uint32))
    lo = np.where(sent, LANE_SENTINEL, (key & 0xFFFFFFFF).astype(np.uint32))
    return hi.astype(np.uint32), lo.astype(np.uint32)


def super_records_to_lanes(mmer, slen, w0, w1):
    """This package's four super-k-mer record lanes (ops/superkmer.py) ->
    the JAX package's six uint32 lanes (mmer, s, b0, b1, b2, b3), every
    lane all ones at a slot that holds no record."""
    mm = _np(mmer).astype(np.int64)
    rec = mm != MMER_SENTINEL
    w0 = _np(w0).astype(np.int64).view(np.uint64)
    w1 = _np(w1).astype(np.int64).view(np.uint64)
    lanes = (mm, _np(slen).astype(np.int64), w0 & 0xFFFFFFFF, w0 >> np.uint64(32),
             w1 & 0xFFFFFFFF, w1 >> np.uint64(32))
    return tuple(np.where(rec, lane.astype(np.uint32), LANE_SENTINEL) for lane in lanes)


def super_records_from_lanes(mmer, slen, b0, b1, b2, b3):
    """The JAX package's six super-record lanes -> this package's four
    (mmer int32, s int32, w0 int64, w1 int64) CPU tensors; a slot whose
    mmer lane is all ones holds no record (MMER_SENTINEL, 0, 0, 0) -- the
    base lanes cannot say so, a word of 16 A bases is all ones too."""
    mm = _np(mmer).astype(np.uint32)
    rec = mm != LANE_SENTINEL

    def word(lo, hi):
        w = (_np(hi).astype(np.uint64) << np.uint64(32)) | _np(lo).astype(np.uint64)
        return np.where(rec, w.view(np.int64), 0)
    return (
        torch.from_numpy(np.where(rec, mm.astype(np.int64), MMER_SENTINEL).astype(np.int32)),
        torch.from_numpy(np.where(rec, _np(slen).astype(np.int64), 0).astype(np.int32)),
        torch.from_numpy(word(b0, b1)),
        torch.from_numpy(word(b2, b3)),
    )


def read_batch_to_torch(batch: ReadBatch):
    """ReadBatch (either package's: same numpy fields) -> CPU tensors
    (codes uint8, lengths int32, read_ids int64: torch has no uint32
    arithmetic on the CPU, and ids are below 2^32)."""
    return (
        torch.from_numpy(np.ascontiguousarray(batch.codes)),
        torch.from_numpy(np.ascontiguousarray(batch.lengths)),
        torch.from_numpy(np.asarray(batch.read_ids).astype(np.int64)),
    )


def window_records_from_lanes(mmer, kmer_hi, kmer_lo, valid) -> WindowRecords:
    """JAX ``WindowRecords`` fields (numpy) -> this package's, with the
    masking this package folds into the scan: slots that are not valid
    become sentinels (the JAX scan leaves them unspecified)."""
    valid = _np(valid).astype(bool)
    key = np.where(valid, lanes_to_key(kmer_hi, kmer_lo), np.int64(SENTINEL))
    mm = np.where(valid, _np(mmer).astype(np.int64), MMER_SENTINEL).astype(np.int32)
    return WindowRecords(
        mmer=torch.from_numpy(mm),
        kmer=torch.from_numpy(key),
        valid=torch.from_numpy(valid),
    )


def window_records_to_lanes(recs: WindowRecords):
    """This package's ``WindowRecords`` -> (mmer uint32, kmer_hi, kmer_lo,
    valid) numpy arrays in the JAX convention, sentinels mapped."""
    mm = _np(recs.mmer).astype(np.int64)
    mmer = np.where(mm == MMER_SENTINEL, np.int64(LANE_SENTINEL), mm).astype(np.uint32)
    hi, lo = key_to_lanes(recs.kmer)
    return mmer, hi, lo, _np(recs.valid).astype(bool)


def key_counts_from_lanes(kmer_hi, kmer_lo, valid, group_start, keep) -> KeyCounts:
    """JAX ``KeyCounts`` fields (numpy) -> this package's ``KeyCounts``."""
    return KeyCounts(
        kmer=torch.from_numpy(lanes_to_key(kmer_hi, kmer_lo)),
        valid=torch.from_numpy(_np(valid).astype(bool)),
        group_start=torch.from_numpy(_np(group_start).astype(bool)),
        keep=torch.from_numpy(_np(keep).astype(bool)),
    )


def key_counts_to_lanes(kc: KeyCounts):
    """``KeyCounts`` -> (kmer_hi, kmer_lo, valid, group_start, keep) numpy."""
    hi, lo = key_to_lanes(kc.kmer)
    return hi, lo, _np(kc.valid), _np(kc.group_start), _np(kc.keep)


def padded_keys_from_lanes(khi, klo, valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """The padded ``(khi, klo, valid)`` triple the JAX dBG functions take
    -> this package's ``(kmer, valid)`` pair."""
    return (
        torch.from_numpy(lanes_to_key(khi, klo)),
        torch.from_numpy(_np(valid).astype(bool)),
    )


def padded_keys_to_lanes(kmer, valid):
    """``(kmer, valid)`` -> the padded ``(khi, klo, valid)`` numpy triple."""
    hi, lo = key_to_lanes(kmer)
    return hi, lo, _np(valid).astype(bool)


def graph_from_int32(next_state, head, rank, is_cycle) -> CompactedGraph:
    """JAX ``CompactedGraph`` fields (numpy int32) -> int64 tensors."""
    return CompactedGraph(
        next_state=torch.from_numpy(_np(next_state).astype(np.int64)),
        head=torch.from_numpy(_np(head).astype(np.int64)),
        rank=torch.from_numpy(_np(rank).astype(np.int64)),
        is_cycle=torch.from_numpy(_np(is_cycle).astype(bool)),
    )


def graph_to_int32(graph: CompactedGraph):
    """``CompactedGraph`` -> (next_state, head, rank int32; is_cycle bool)
    numpy arrays, the JAX package's field types."""
    return (
        _np(graph.next_state).astype(np.int32),
        _np(graph.head).astype(np.int32),
        _np(graph.rank).astype(np.int32),
        _np(graph.is_cycle).astype(bool),
    )


def counted_table_from_lanes(
    mmer, kmer_hi, kmer_lo, read_id, stream_idx, valid, group_start, count, keep
) -> CountedTable:
    """JAX ``CountedTable`` fields (numpy) -> this package's.  Rows that
    are not valid get MMER_SENTINEL / SENTINEL (the JAX table leaves the
    k-mer lanes of its invalid tail as the padding packs them)."""
    valid = _np(valid).astype(bool)
    mm = np.where(valid, _np(mmer).astype(np.int64), MMER_SENTINEL).astype(np.int32)
    key = np.where(valid, lanes_to_key(kmer_hi, kmer_lo), np.int64(SENTINEL))
    return CountedTable(
        mmer=torch.from_numpy(mm),
        kmer=torch.from_numpy(key),
        read_id=torch.from_numpy(_np(read_id).astype(np.int64)),
        stream_idx=torch.from_numpy(_np(stream_idx).astype(np.int64)),
        valid=torch.from_numpy(valid),
        group_start=torch.from_numpy(_np(group_start).astype(bool)),
        count=torch.from_numpy(_np(count).astype(np.int64)),
        keep=torch.from_numpy(_np(keep).astype(bool)),
    )


def counted_table_to_lanes(ct: CountedTable):
    """``CountedTable`` -> (mmer, kmer_hi, kmer_lo, read_id, stream_idx,
    valid, group_start, count, keep) numpy arrays in the JAX package's
    types (uint32 lanes, int32 count); sentinels mapped to all-ones."""
    mm = _np(ct.mmer).astype(np.int64)
    mmer = np.where(mm == MMER_SENTINEL, np.int64(LANE_SENTINEL), mm).astype(np.uint32)
    hi, lo = key_to_lanes(ct.kmer)
    return (
        mmer, hi, lo,
        _np(ct.read_id).astype(np.uint32),
        _np(ct.stream_idx).astype(np.uint32),
        _np(ct.valid).astype(bool),
        _np(ct.group_start).astype(bool),
        _np(ct.count).astype(np.int32),
        _np(ct.keep).astype(bool),
    )


def host_table_from_lanes(mmer, kmer_hi, kmer_lo, count, first_seen, read_ids) -> HostTable:
    """JAX ``HostTable`` fields -> this package's (one int64 k-mer key)."""
    return HostTable(
        mmer=_np(mmer).astype(np.uint32),
        kmer=lanes_to_key(kmer_hi, kmer_lo),
        count=_np(count).astype(np.int32),
        first_seen=_np(first_seen).astype(np.uint32),
        read_ids=[_np(r).astype(np.uint32) for r in read_ids],
    )


def host_table_to_lanes(host: HostTable):
    """``HostTable`` -> (mmer, kmer_hi, kmer_lo, count, first_seen,
    read_ids), the fields of the JAX package's ``HostTable`` in order."""
    hi, lo = key_to_lanes(host.kmer)
    return (
        _np(host.mmer).astype(np.uint32), hi, lo,
        _np(host.count).astype(np.int32),
        _np(host.first_seen).astype(np.uint32),
        [_np(r).astype(np.uint32) for r in host.read_ids],
    )


def sharded_count_to_lanes(sc: ShardedCount):
    """``ShardedCount`` of a one-process mesh (every shard local) -> the
    JAX package's ``ShardedCount`` fields as numpy ``[n_shards, R]`` arrays
    in its types, ``overflow`` int32 ``[n_shards]``.  Rows without a record
    map as ``counted_table_to_lanes`` maps them."""
    shards = [counted_table_to_lanes(CountedTable(*(getattr(sc, f)[i]
                                                    for f in CountedTable._fields)))
              for i in range(len(sc.mmer))]
    overflow = np.asarray([int(x) for x in sc.overflow], dtype=np.int32)
    return (*(np.stack(lane) for lane in zip(*shards)), overflow)


def sharded_count_from_lanes(mmer, kmer_hi, kmer_lo, read_id, stream_idx, valid, group_start,
                             count, keep, overflow) -> ShardedCount:
    """The JAX package's ``ShardedCount`` fields ([n_shards, R] numpy) ->
    this package's, one CPU tensor a shard in each field."""
    lanes = [_np(x) for x in (mmer, kmer_hi, kmer_lo, read_id, stream_idx, valid, group_start,
                              count, keep)]
    tables = [counted_table_from_lanes(*(lane[s] for lane in lanes))
              for s in range(lanes[0].shape[0])]
    return ShardedCount(*(list(f) for f in zip(*tables)),
                        [torch.tensor(int(v)) for v in _np(overflow)])

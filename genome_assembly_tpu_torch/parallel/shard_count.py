"""Owner-sharded distributed k-mer counting.

  1. Each shard scans its rows of the read batch (data parallel): fast
     mode's scan is K1 on a card (ops/minimizer.fast_scan).
  2. Every record is routed to its owner shard -- ``owner_of(minimizer)``,
     or ``key_owner_of(canonical key)`` in fast mode -- by an all-to-all
     exchange: capacity-padded ``[n_shards, cap]`` blocks, or ragged exact
     sizes under one budget a receiver (parallel/ragged.py).
  3. Each shard sorts and segment-counts the records it owns; owners hold
     whole groups, so pruning is local.

Overflow is counted, never silent: a record that does not fit its block
(or its receiver's budget) is dropped and counted on the shard that sent
it; callers re-run with more ``slack``.

Records are the port's lanes: int32 m-mer (MMER_SENTINEL where none), the
int64 key (SENTINEL), int64 read id and int64 stream index.  A slot that
holds no record has ``FILLS`` in every lane and sorts past every record.
The JAX package's stream lane is uint32; here it is int64.

Every per-shard step is a plain function over one shard's tensors; the
drivers loop over the mesh's local shards (parallel/mesh.py), so the same
code runs on a one-process mesh and one shard a process.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from genome_assembly_tpu_torch.common import HASH_A, HASH_B, MASK32, MMER_SENTINEL, SENTINEL
from genome_assembly_tpu_torch.ops import count as count_ops
from genome_assembly_tpu_torch.ops import outofcore
from genome_assembly_tpu_torch.ops import encode
from genome_assembly_tpu_torch.ops import minimizer
from genome_assembly_tpu_torch.parallel import ragged
from genome_assembly_tpu_torch.parity.table import HostTable

# Knuth's multiplicative constant; spreads consecutive minimizer values.
HASH_MULT = 2654435761

# fill of each lane (m-mer, key, read id, stream) at a slot without a record
FILLS = (MMER_SENTINEL, SENTINEL, SENTINEL, SENTINEL)

NEXT_SLICE = "the second multi-device slice (ROADMAP.md queue 1 item 4)"


def owner_of(mmer: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Shard owning a minimizer: ``((mmer * HASH_MULT) mod 2^32 >> 8) % n``."""
    return (((mmer.to(torch.int64) * HASH_MULT) & MASK32) >> 8) % n_shards


def key_owner_of(kmer: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Shard owning a canonical k-mer key: the two-lane hash of the key.

    Fast mode's ownership: minimizer mass is heavy-tailed, so at high shard
    counts the biggest minimizers dominate single shards; a key's
    multiplicity is about the coverage.  All copies of a key share its
    owner and a key's minimizer is a function of the key, so the
    shard-local (mmer, key) groups stay whole.  Parity mode keeps minimizer
    ownership: the replay consumes signature-grouped tables."""
    return (outofcore._mix_key(kmer, HASH_A, HASH_B) >> 7) % n_shards


class ShardedCount(NamedTuple):
    """A counted table partitioned over a mesh: every field is a list with
    one tensor a local shard (all of one length), the fields of
    ops/count.CountedTable; ``overflow`` holds each shard's dropped-record
    count (a 0-d int64 tensor; want all zero)."""

    mmer: List[torch.Tensor]
    kmer: List[torch.Tensor]
    read_id: List[torch.Tensor]
    stream_idx: List[torch.Tensor]
    valid: List[torch.Tensor]
    group_start: List[torch.Tensor]
    count: List[torch.Tensor]
    keep: List[torch.Tensor]
    overflow: List[torch.Tensor]


def _routing_cap(n_local: int, n_shards: int, slack: float, routing: str) -> int:
    """Records a (source, destination) block holds (padded), or a receiver
    takes (ragged): the JAX package's float expression, so the overflow
    counters agree on the same input."""
    if routing == "ragged":
        return int(np.ceil(n_local * slack))
    return int(np.ceil(n_local / n_shards * slack))


def _check_route_by(route_by: str, parity: bool) -> None:
    if route_by not in ("mmer", "key"):
        raise ValueError(f"unknown route_by {route_by!r}")
    if route_by == "key" and parity:
        raise ValueError(
            "parity mode requires minimizer ownership (route_by='mmer'): "
            "the replay consumes signature-grouped tables"
        )


def _bucketize_records(codes, lengths, read_ids, stream_offset: int, *, k, m, parity,
                       n_shards, cap, routing="padded", route_by="mmer"):
    """One shard: scan, then owner-sorted staging; no collective.

    Returns a list that ``_exchange_staged`` consumes:
      padded: [m-mer, key, read id, stream blocks [n_shards, cap], overflow]
      ragged: [owner [n] sorted, payload [n, 4] int64 in owner order, 0]
    """
    scan = minimizer.parity_scan if parity else minimizer.fast_scan
    recs = scan(codes, lengths, k=k, m=m)
    n_win = recs.kmer.shape[1]
    n = recs.kmer.numel()
    mmer = recs.mmer.reshape(n)
    kmer = recs.kmer.reshape(n)
    dest = key_owner_of(kmer, n_shards) if route_by == "key" else owner_of(mmer, n_shards)
    owner = torch.where(recs.valid.reshape(n), dest, n_shards)
    del dest, recs
    # sort by owner, stable: a record's slot in its block is its rank
    # among the records of its owner, in (read, window) order
    owner_s, order = torch.sort(owner, stable=True)
    del owner
    read_ids = read_ids.to(torch.int64)
    zero = torch.zeros((), dtype=torch.int64, device=codes.device)
    if routing == "ragged":
        payload = torch.stack([mmer[order].to(torch.int64), kmer[order],
                               read_ids[order // n_win], order + stream_offset], dim=1)
        return [owner_s, payload, zero]
    targets = torch.arange(n_shards + 1, dtype=torch.int64, device=codes.device)
    starts = torch.searchsorted(owner_s, targets, side="left")
    slot = torch.arange(n, device=codes.device) - starts[owner_s]
    routed = owner_s < n_shards
    overflow = ((slot >= cap) & routed).sum()
    sel = torch.nonzero((slot < cap) & routed).reshape(-1)
    src = order[sel]
    dst = owner_s[sel] * cap + slot[sel]
    del owner_s, order, slot, routed, sel
    lanes = (mmer[src], kmer[src], read_ids[src // n_win], src + stream_offset)
    blocks = []
    for lane, fill in zip(lanes, FILLS):
        buf = lane.new_full((n_shards * cap,), fill)
        buf[dst] = lane
        blocks.append(buf.view(n_shards, cap))
    return [*blocks, overflow + zero]


def _exchange_staged(staged: List[list], *, n_shards, cap, routing, mesh):
    """The collective half of the routing step.

    staged: ``_bucketize_records``' lists, one a local shard.  They are
    consumed: each lane's staging is dropped as soon as it is sent.
    Returns one list [m-mer, key, read id, stream, overflow] a local
    shard: the records it received (FILLS-padded) and its overflow."""
    if routing == "ragged":
        owners = [st[0] for st in staged]
        payload = [st[1] for st in staged]
        overflow = [st[2] for st in staged]
        staged.clear()
        received, dropped = ragged.route_records_ragged(
            owners, payload, n_shards=n_shards, cap_total=cap, mesh=mesh)
        del owners, payload
        out = []
        for r, ovf, drop in zip(received, overflow, dropped):
            mm = torch.where(r[:, 0] == SENTINEL, MMER_SENTINEL, r[:, 0]).to(torch.int32)
            out.append([mm, r[:, 1].clone(), r[:, 2].clone(), r[:, 3].clone(), ovf + drop])
        return out
    out = [[] for _ in staged]
    for lane in range(len(FILLS)):
        blocks = []
        for st in staged:
            blocks.append(st[lane])
            st[lane] = None
        for dst, got in zip(out, mesh.all_to_all(blocks)):
            dst.append(got.reshape(-1))
        del blocks
    for dst, st in zip(out, staged):
        dst.append(st[len(FILLS)])
    staged.clear()
    return out


def _local_count(mmer, kmer, read_id, stream, *, cutoff: int) -> count_ops.CountedTable:
    """Sort and count the records this shard owns (its groups are whole):
    stable by (m-mer, key, stream), so a group's read ids come in stream
    order; the FILLS rows sort last and form one group of their own."""
    order = count_ops._mmer_kmer_order(mmer, kmer, minor=stream)
    return count_ops._parity_groups(
        mmer[order], kmer[order], read_id[order], stream[order], cutoff)


def _cat(parts: List[torch.Tensor]) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _count_received(received: List[List[list]], *, cutoff: int, n_local: int) -> ShardedCount:
    """received: a list over batches of ``_exchange_staged``'s per-shard
    lists.  Each shard concatenates its batches' records and counts once;
    its batches' lanes are dropped as it goes."""
    tables, overflow = [], []
    for i in range(n_local):
        per_batch = [batch[i] for batch in received]
        for batch in received:
            batch[i] = None
        lanes = [_cat([b[lane] for b in per_batch]) for lane in range(len(FILLS))]
        overflow.append(sum(b[len(FILLS)] for b in per_batch))
        del per_batch
        tables.append(_local_count(*lanes, cutoff=cutoff))
        del lanes
    return ShardedCount(*(list(f) for f in zip(*tables)), overflow)


def _batch_tensors(codes, lengths, read_ids):
    """A batch's fields as tensors (codes uint8, lengths int32, read ids
    int64); tensors pass as they are."""
    def tensor(x, dtype):
        return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x).astype(dtype))
    return tensor(codes, np.uint8), tensor(lengths, np.int32), tensor(read_ids, np.int64)


def _route_records(codes, lengths, read_ids, batch_offset: int, *, k, m, parity, mesh, cap,
                   routing, route_by):
    """One batch's routed (uncounted) records: each local shard scans and
    stages its rows, then the exchange; one ``_exchange_staged`` list a
    local shard.  The stream index of a slot is its (row, window) position
    in the whole read set: ``batch_offset`` + shard * n_local + its
    position in the shard."""
    n_shards = mesh.n_shards
    if codes.shape[0] % n_shards:
        raise ValueError(f"batch of {codes.shape[0]} rows must divide the mesh size {n_shards}")
    n_local = codes.shape[0] // n_shards * (codes.shape[1] - k + 1)
    staged = [
        _bucketize_records(c, l, r, batch_offset + s * n_local, k=k, m=m, parity=parity,
                           n_shards=n_shards, cap=cap, routing=routing, route_by=route_by)
        for s, c, l, r in zip(mesh.local, mesh.shard_rows(codes), mesh.shard_rows(lengths),
                              mesh.shard_rows(read_ids))
    ]
    return _exchange_staged(staged, n_shards=n_shards, cap=cap, routing=routing, mesh=mesh)


def _check_routing(routing: str, route_by: str, parity: bool) -> None:
    if routing not in ("padded", "ragged", "two_level"):
        raise ValueError(f"unknown routing {routing!r}")
    _check_route_by(route_by, parity)
    if route_by == "key" and routing == "two_level":
        raise ValueError("two_level routing routes by minimizer only")
    if routing == "two_level":
        raise NotImplementedError(
            f"routing='two_level' (parallel/two_level.py) is not ported yet: {NEXT_SLICE}")


def sharded_count(
    codes, lengths, read_ids, *, k: int, m: int, parity: bool, cutoff: int, mesh,
    slack: float = 4.0, routing: str = "padded", route_by: str = "mmer",
) -> ShardedCount:
    """Distributed count and prune of one batch over a mesh.

    codes [B, L] uint8, lengths [B], read_ids [B]: the whole batch (tensors
    or numpy, any device); B must divide by the mesh size, and each shard
    takes its rows onto its device.  routing="ragged" exchanges exact
    record counts under one budget of n_local * slack records a receiver
    instead of a block a (source, destination) pair: the same memory bound,
    immune to per-pair skew."""
    _check_routing(routing, route_by, parity)
    n_shards = mesh.n_shards
    batch, max_len = codes.shape
    n_local = batch // n_shards * (max_len - k + 1)
    cap = _routing_cap(n_local, n_shards, slack, routing)
    received = _route_records(*_batch_tensors(codes, lengths, read_ids), 0, k=k, m=m,
                              parity=parity, mesh=mesh, cap=cap, routing=routing,
                              route_by=route_by)
    return _count_received([received], cutoff=cutoff, n_local=len(mesh.local))


def sharded_count_batches(
    batches, *, k: int, m: int, parity: bool, cutoff: int, mesh, slack: float = 4.0,
    routing: str = "padded", route_by: str = "mmer", checkpoint_dir: str | None = None,
) -> ShardedCount:
    """Distributed count over several read batches (any total size).

    Each batch is routed as it comes; every shard keeps the records it owns
    across batches and counts once at the end, so groups spanning batches
    are whole and the result equals one run over the concatenated reads.

    batches: ``io.reads.ReadBatch`` es, all padded to one row count
    (divisible by the mesh size); read ids consecutive across batches.
    checkpoint_dir (resumable count shards) is not ported yet.
    """
    if checkpoint_dir is not None:
        raise NotImplementedError(
            f"sharded_count_batches(checkpoint_dir=) is not ported yet: {NEXT_SLICE}")
    if routing not in ("padded", "ragged"):
        raise ValueError(f"unknown routing {routing!r}")
    _check_route_by(route_by, parity)
    n_shards = mesh.n_shards
    received, cap, n_local = [], None, None
    for bi, b in enumerate(batches):
        codes, lengths, rids = _batch_tensors(b.codes, b.lengths, b.read_ids)
        if n_local is None:
            n_local = codes.shape[0] // n_shards * (codes.shape[1] - k + 1)
            cap = _routing_cap(n_local, n_shards, slack, routing)
        # global stream order: batch-major, then shard, then local slot
        received.append(_route_records(
            codes, lengths, rids, bi * n_shards * n_local, k=k, m=m, parity=parity, mesh=mesh,
            cap=cap, routing=routing, route_by=route_by))
    if not received:
        raise ValueError("no batches")
    return _count_received(received, cutoff=cutoff, n_local=len(mesh.local))


# ---------------------------------------------------------------------------
# host views (tests, the parity replay)
# ---------------------------------------------------------------------------


def host_lanes(sc: ShardedCount, mesh, names=ShardedCount._fields[:-1]):
    """The named fields of every shard on the host, ``[n_shards, R]`` numpy."""
    return {name: mesh.to_host(getattr(sc, name)) for name in names}


def _sharded_groups(sc: ShardedCount, mesh, with_streams: bool = True):
    """Every valid group of every shard, ordered by its first stream index
    (the global insertion order).  Returns (mmer uint32, kmer int64,
    offsets, flat read ids int32, flat streams uint32 or None)."""
    lanes = host_lanes(sc, mesh, ("mmer", "kmer", "read_id", "stream_idx", "valid",
                                  "group_start", "count"))
    r = lanes["mmer"].shape[1]
    # shard-major, then position: the order the JAX package walks the groups
    s_idx, g_idx = np.nonzero(lanes["group_start"] & lanes["valid"])
    first = lanes["stream_idx"][s_idx, g_idx]
    order = np.argsort(first, kind="stable")
    sizes = lanes["count"][s_idx, g_idx][order].astype(np.int64)
    offsets = np.zeros(len(order) + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    base = (s_idx.astype(np.int64) * r + g_idx)[order]
    pos = (np.repeat(base, sizes)
           + np.arange(offsets[-1], dtype=np.int64) - np.repeat(offsets[:-1], sizes))
    flat_ids = lanes["read_id"].reshape(-1)[pos].astype(np.int32)
    flat_streams = (lanes["stream_idx"].reshape(-1)[pos].astype(np.uint32)
                    if with_streams else None)
    mmer = lanes["mmer"][s_idx, g_idx][order].astype(np.uint32)
    kmer = lanes["kmer"][s_idx, g_idx][order]
    return mmer, kmer, offsets, flat_ids, flat_streams


def sharded_groups_for_replay(sc: ShardedCount, mesh):
    """ShardedCount (counted with cutoff -1) -> insertion-ordered host
    groups (mmer, kmer, id_offsets, read_ids): the native replay's input.
    Ownership loses no order: each group carries its global first stream."""
    return _sharded_groups(sc, mesh, with_streams=False)[:4]


def sharded_host_table_with_streams(sc: ShardedCount, mesh):
    """ShardedCount -> (parity HostTable, per-group occurrence streams), in
    insertion order: what the non-ACGT regroup (parity/nonacgt.py) needs."""
    mmer, kmer, offsets, flat_ids, flat_streams = _sharded_groups(sc, mesh)
    bounds = list(zip(offsets[:-1].tolist(), offsets[1:].tolist()))
    read_ids = [flat_ids[a:b].astype(np.uint32) for a, b in bounds]
    streams = [flat_streams[a:b] for a, b in bounds]
    host = HostTable(
        mmer=mmer, kmer=kmer, count=np.diff(offsets).astype(np.int32),
        first_seen=np.asarray([s[0] if len(s) else 0 for s in streams], dtype=np.uint32),
        read_ids=read_ids)
    return host, streams


def sharded_to_host_dict(sc: ShardedCount, k: int, m: int, mesh):
    """The kept groups as the string-keyed dict (tests): (mmer, kmer) ->
    read ids, newest first.  Shards own disjoint groups: a concatenation."""
    lanes = host_lanes(sc, mesh)
    out = {}
    for s, g in zip(*np.nonzero(lanes["keep"])):
        c = int(lanes["count"][s, g])
        sig = encode.unpack_int(int(lanes["mmer"][s, g]), m)
        kmer = encode.unpack_int(int(lanes["kmer"][s, g]), k)
        ids = lanes["read_id"][s, g:g + c]
        order = np.argsort(lanes["stream_idx"][s, g:g + c], kind="stable")
        out[(sig, kmer)] = list(map(int, ids[order][::-1]))
    return out

"""Fast-mode de Bruijn graph compaction: unitigs via parallel pointer jumping.

  1. The pruned canonical k-mer set is a sorted key tensor (the nodes).
  2. Each node has two directed states, ``2 * node + strand`` (strand 0 =
     the canonical key's own orientation, 1 = its reverse complement).
     State s has a *unitig edge* to its unique successor t iff
     out-degree(s) == 1 and in-degree(t) == 1.
  3. The unitig-edge relation is a functional graph whose maximal paths
     are the unitigs; pointer doubling ranks every state in
     O(log chain-length) rounds.  Cycles are broken at their minimum
     state id, found by min-propagation during the same rounds.

Requires odd k (no reverse-complement palindromes).

The device half (``build_unitig_links_join``, ``pointer_jump``) works on
tensors; the string assembly (``materialize_unitigs`` and below) is host
numpy, fed from ``.cpu().numpy()``.  State ids are int64 here (torch
indexes with int64); the JAX package carries them as int32.

Both materializers time the same steps as spans of the run in progress
(``utils/profiling.span``): ``readback``, ``revcomp`` (all 2N states on
the host; the chain heads alone on the device path), ``cycles``, ``sort``
(the walk sort), ``spell`` (the byte buffer) and ``strands``
(``_canonical_chain_strings``).  Every array they read back counts as
``d2h_bytes``.
"""

from __future__ import annotations

import math
import time
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from genome_assembly_tpu_torch.common import SENTINEL
from genome_assembly_tpu_torch.ops import encode
from genome_assembly_tpu_torch.utils import profiling


class CompactedGraph(NamedTuple):
    """Per-state chain assignment from pointer jumping; all length 2N."""

    next_state: torch.Tensor  # unitig-edge successor state or -1
    head: torch.Tensor  # chain head state id
    rank: torch.Tensor  # position within chain
    is_cycle: torch.Tensor  # state belongs to a cyclic chain


def _shift_next(x: torch.Tensor, fill) -> torch.Tensor:
    return torch.cat([x[1:], x.new_full((1,), fill)])


def _shift_prev(x: torch.Tensor, fill) -> torch.Tensor:
    return torch.cat([x.new_full((1,), fill), x[:-1]])


def build_unitig_links_join(
    kmer: torch.Tensor, valid: torch.Tensor, *, k: int
) -> torch.Tensor:
    """next_state[2N] via a (k-1)-mer sort-join.

    kmer: [N] int64 sorted canonical keys, sentinel-padded; valid marks
    real rows.  Every state (oriented k-mer v) emits two records keyed by
    a (k-1)-mer value: an OUT record keyed by suffix(v) and an IN record
    keyed by prefix(v).  Edge s->t exists iff suffix(v_s) == prefix(v_t),
    i.e. exactly the key groups; s->t is a unitig edge iff its group is
    exactly one OUT row and one IN row and t != flip(s).

    The records are laid out OUT rows then IN rows, each in state order,
    so record index == (side, state) order and ONE stable sort by key
    leaves every group ordered OUT-before-IN, by state within a side.
    """
    if k % 2 == 0:
        raise ValueError("fast-mode dBG requires odd k (no RC palindromes)")
    n = kmer.shape[0]
    n2 = 2 * n
    if n2 >= 1 << 31:
        raise ValueError(f"{n2} states do not fit the (side, state) record layout")
    if n == 0:
        return kmer.new_empty((0,))

    # oriented value of state 2*node + strand, interleaved
    oriented = torch.stack(
        [kmer, encode.reverse_complement_packed(kmer, k)], dim=1
    ).reshape(n2)
    state_valid = valid.repeat_interleave(2)

    suffix = oriented & ((1 << (2 * k - 2)) - 1)
    prefix = oriented >> 2
    key = torch.cat(
        [
            torch.where(state_valid, suffix, SENTINEL),
            torch.where(state_valid, prefix, SENTINEL),
        ]
    )
    key_s, rec = torch.sort(key, stable=True)
    side_s = (rec >= n2).long()
    state_s = rec - side_s * n2
    row_valid = key_s != SENTINEL  # real (k-1)-mers are < 2^60

    # the end fill differs from every key AND from the sentinel, so the
    # shifted compares are false at both ends of the array
    edge_fill = SENTINEL ^ 1
    same_next = _shift_next(key_s, edge_fill) == key_s
    same_prev = _shift_prev(key_s, edge_fill) == key_s
    # group of exactly two rows: OUT at i, IN at i+1
    pair = (
        ~same_prev
        & same_next
        & ~_shift_next(same_next, True)
        & (side_s == 0)
        & (_shift_next(side_s, 1) == 1)
        & row_valid
    )
    target = _shift_next(state_s, -1)
    hairpin = target == (state_s ^ 1)
    edge_rows = torch.nonzero(pair & ~hairpin).reshape(-1)

    next_state = kmer.new_full((n2,), -1)
    next_state[state_s[edge_rows]] = target[edge_rows]
    return next_state


def pointer_jump(next_state: torch.Tensor) -> CompactedGraph:
    """List-rank the unitig chains: head id + rank per state.

    Pointer doubling over *predecessor* links with head-absorbing
    self-loops: after ceil(log2(2N)) rounds every acyclic state has jumped
    to its chain head with its distance accumulated.  Cycles (no head)
    adopt the minimum state id on the cycle -- propagated by the same
    doubling -- as a deterministic representative.

    The loop stops when no parent moved in a round (one read-back per
    round): parents of acyclic states stop changing once absorbed, cycles
    keep rotating, and by then the doubling window covers every cycle.
    """
    n2 = next_state.shape[0]
    steps = max(1, math.ceil(math.log2(max(n2, 2))) + 1)
    ids = torch.arange(n2, dtype=torch.int64, device=next_state.device)

    # unique predecessor (in-degree <= 1 by the unitig-edge rule)
    pred = torch.full_like(ids, -1)
    src = torch.nonzero(next_state >= 0).reshape(-1)
    pred[next_state[src]] = src

    # head-absorbing parent: heads (pred == -1) self-loop with rank 0
    parent = torch.where(pred >= 0, pred, ids)
    rank = (pred >= 0).long()
    min_id = torch.minimum(ids, parent)

    r, changed = 0, True
    while r < steps and changed:
        parent2 = parent[parent]
        rank = rank + rank[parent]
        min_id = torch.minimum(min_id, min_id[parent])
        changed = bool((parent2 != parent).any())
        parent = parent2
        r += 1

    # acyclic states were absorbed at the head (whose pred is -1); cyclic
    # states' parent is still somewhere on the cycle
    is_cycle = pred[parent] >= 0
    head = torch.where(is_cycle, min_id, parent)
    # cycle ranks depend on the round count: zero them so every
    # implementation agrees; the materializer re-ranks cycles by walking
    rank = torch.where(is_cycle, 0, rank)
    return CompactedGraph(
        next_state=next_state, head=head, rank=rank, is_cycle=is_cycle
    )


# ---------------------------------------------------------------------------
# Past device memory: the out-of-core link join and the bulk jump.
# ---------------------------------------------------------------------------

# Link records: a (k-1)-mer key and a payload ``side << 62 | state``
# (side 0 = OUT, keyed by the state's suffix; 1 = IN, keyed by its prefix).
# The JAX package packs ``side << 31 | state`` into uint32; bit 62 leaves
# the state id all of int64's range below it.
_SIDE_SHIFT = 62
_STATE_MASK = (1 << _SIDE_SHIFT) - 1

# staging budget of one link pass, the JAX package's default
LINK_GROUP_BUDGET_BYTES = 5 << 30


def _chunk_boundary_records(kmer_c: torch.Tensor, valid_c: torch.Tensor,
                            base_node: int, *, k: int):
    """OUT/IN boundary records of one chunk of nodes, both strands.

    Returns (key, payload), each 4 * chunk long: OUT forward, OUT reverse,
    IN forward, IN reverse; payload = side << 62 | global state id.  Rows
    of invalid nodes are SENTINEL in both lanes.  Record order is free:
    the records are hash-partitioned and sorted downstream.
    """
    chunk = kmer_c.shape[0]
    g0 = 2 * (base_node + torch.arange(chunk, dtype=torch.int64, device=kmer_c.device))
    gid = torch.cat([g0, g0 + 1])
    oriented = torch.cat([kmer_c, encode.reverse_complement_packed(kmer_c, k)])
    state_valid = torch.cat([valid_c, valid_c])
    suffix = oriented & ((1 << (2 * k - 2)) - 1)
    prefix = oriented >> 2
    key = torch.cat([torch.where(state_valid, suffix, SENTINEL),
                     torch.where(state_valid, prefix, SENTINEL)])
    payload = torch.cat([torch.where(state_valid, gid, SENTINEL),
                         torch.where(state_valid, gid | (1 << _SIDE_SHIFT), SENTINEL)])
    return key, payload


def _partition_edges(key: torch.Tensor, payload: torch.Tensor):
    """Sort one partition's records and pair-test: (src or -1, dst).

    The exactly-two-rows OUT-then-IN group test of
    ``build_unitig_links_join``, over records whose key groups are
    complete (all of a (k-1)-mer's records share its hash partition).  A
    (k-1)-mer is below 2^60, so (key, side) sorts as ONE int64
    ``key << 1 | side``: a group of one OUT and one IN row comes out OUT
    first, and no other group can pass the test whatever its order.
    """
    valid = key != SENTINEL
    side = payload >> _SIDE_SHIFT
    order = torch.sort(torch.where(valid, (key << 1) | side, SENTINEL), stable=True).indices
    key_s, pay_s = key[order], payload[order]
    side_s = pay_s >> _SIDE_SHIFT
    state_s = pay_s & _STATE_MASK
    edge_fill = SENTINEL ^ 1
    same_next = _shift_next(key_s, edge_fill) == key_s
    same_prev = _shift_prev(key_s, edge_fill) == key_s
    pair = (
        ~same_prev
        & same_next
        & ~_shift_next(same_next, True)
        & (side_s == 0)
        & (_shift_next(side_s, 1) == 1)
        & (key_s != SENTINEL)
    )
    target = _shift_next(state_s, -1)
    edge = pair & (target != (state_s ^ 1))
    return torch.where(edge, state_s, -1), target


def _scatter_edges(next_state: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> None:
    """next_state[src] = dst where src >= 0, in place; rows without an edge
    write into the last slot, which the caller keeps spare (no read-back)."""
    spare = next_state.shape[0] - 1
    next_state.scatter_(0, torch.where(src >= 0, src, spare), dst)


def build_unitig_links_ooc(
    kmer: torch.Tensor,
    valid: torch.Tensor,
    *,
    k: int,
    partitions: int,
    chunk_nodes: int = 1 << 24,
) -> torch.Tensor:
    """next_state[2N] for key sets whose 4N-record join sort exceeds
    device memory.

    The same result as ``build_unitig_links_join``, in ceil(P / G)
    passes: each pass makes every chunk's boundary records again
    (arithmetic over the resident keys), extracts a group of G range
    partitions (``outofcore.extract_partition_range3``, G from a staging
    budget), then sorts and pair-tests each partition alone and scatters
    its edges into the link array.  A partition whose statistical staging
    cap overflowed is re-extracted alone after the group's clean ones, so
    no edge is ever lost.

    Returns next_state [2N] int64.  (The JAX package's builder also
    returns an overflow count; here it could only be 0.)  The passes are
    ``build_unitig_links_parked``'s with nothing parked.
    """
    return build_unitig_links_parked(kmer, valid, k=k, partitions=partitions,
                                     chunk_nodes=chunk_nodes)


def _compact_edges(src: torch.Tensor, dst: torch.Tensor):
    """Real edges to the front, in ascending ``src``, for a thin read-back:
    (src with non-edges SENTINEL, dst in the same order, the edge count
    as a device scalar)."""
    key_s, order = torch.sort(torch.where(src >= 0, src, SENTINEL))
    return key_s, dst[order], (src >= 0).sum()


def build_unitig_links_parked(
    kmer,
    valid,
    *,
    k: int,
    partitions: int,
    chunk_nodes: int = 1 << 24,
    park_links: bool = False,
    on_event=None,
    device="cuda",
):
    """build_unitig_links_ooc with the big residents parked in host RAM.

    - **parked keys**: pass ``kmer``/``valid`` as host numpy arrays; each
      pass uploads them a chunk at a time to ``device`` (the last chunk
      padded there), so the device holds one chunk's keys at a time.
      Tensors are used where they lie (``device`` is then unused).
    - **parked links** (``park_links``): each partition's edges are
      compacted on the device (``_compact_edges``), read back as exactly
      n_edges (src, dst) rows and written into a host next_state, so the
      device never holds the 2N link array.

    ``on_event(kind, **fields)`` reports progress: ``link_pass`` (g,
    chunks, wall_s, cap_bp, overflowed_chunks: per partition of the group,
    the chunks whose share passed cap_bp) after each group's sweep,
    ``link_partition`` (p, wall_s, n_edges; -1 unless park_links) after
    each partition's join, ``link_reextract`` (p, overflowed_chunks) when
    a staging cap overflowed.  The same links
    as ``build_unitig_links_ooc`` and ``build_unitig_links_join``: int64
    numpy [2N] when park_links, else a tensor.
    """
    from genome_assembly_tpu_torch.ops import outofcore

    if k % 2 == 0:
        raise ValueError("fast-mode dBG requires odd k")
    keys_hosted = isinstance(kmer, np.ndarray)
    n = kmer.shape[0]
    n_chunks = -(-n // chunk_nodes)
    rec_per_chunk = 4 * chunk_nodes
    cap_bp, G = outofcore.range_group_plan(
        n_chunks, rec_per_chunk, partitions=partitions,
        bytes_per_record=12, budget_bytes=LINK_GROUP_BUDGET_BYTES,
        sigma_scale=2.9,  # boundary keys join in groups of <= 8 per
        # (k-1)-mer: sqrt(8) deviation inflation
    )
    link_device = torch.device(device) if keys_hosted else kmer.device

    def chunk_records(c):
        s = c * chunk_nodes
        kc, vc = kmer[s: s + chunk_nodes], valid[s: s + chunk_nodes]
        if keys_hosted:
            kc = torch.from_numpy(np.ascontiguousarray(kc))
            vc = torch.from_numpy(np.ascontiguousarray(vc))
            profiling.count("h2d_bytes", kc.nbytes + vc.nbytes)
            kc, vc = kc.to(link_device), vc.to(link_device)
        if kc.shape[0] < chunk_nodes:
            pad = chunk_nodes - kc.shape[0]
            kc = torch.cat([kc, kc.new_full((pad,), SENTINEL)])
            vc = torch.cat([vc, vc.new_zeros((pad,))])
        return _chunk_boundary_records(kc, vc, s, k=k)

    n2p = 2 * n_chunks * chunk_nodes
    if park_links:
        next_host = np.full(n2p, -1, dtype=np.int64)
    else:
        # one spare slot past the states takes the writes of non-edges
        next_state = torch.full((n2p + 1,), -1, dtype=torch.int64, device=link_device)

    def emit(p, key, pay):
        t0 = time.perf_counter()
        src, dst = _partition_edges(key, pay)
        n_edges = -1
        if park_links:
            src_c, dst_c, n_dev = _compact_edges(src, dst)
            del src, dst
            n_edges = int(n_dev)
            src_h, dst_h = src_c[:n_edges].cpu().numpy(), dst_c[:n_edges].cpu().numpy()
            profiling.count("d2h_bytes", src_h.nbytes + dst_h.nbytes)
            next_host[src_h] = dst_h
        else:
            _scatter_edges(next_state, src, dst)
        if on_event is not None:
            on_event("link_partition", p=p, wall_s=round(time.perf_counter() - t0, 3),
                     n_edges=n_edges)

    for g in range(-(-partitions // G)):
        t_sweep = time.perf_counter()
        parts, group_overflows = outofcore.stage_group(
            chunk_records, n_chunks, outofcore.extract_partition_range3, g,
            partitions=partitions, group_size=G, cap_bp=cap_bp,
            dtypes=(torch.int64, torch.int64))
        if on_event is not None:
            on_event("link_pass", g=g, chunks=n_chunks,
                     wall_s=round(time.perf_counter() - t_sweep, 3), cap_bp=cap_bp,
                     overflowed_chunks=group_overflows)
        overflowed = []
        for r in range(G):
            p = g * G + r
            lanes, parts[r] = parts[r], None
            if p >= partitions:
                continue
            if group_overflows[r]:
                # incomplete staging: re-extracted alone after the group
                overflowed.append(p)
                continue
            emit(p, *lanes)
            del lanes
        del parts
        for p in overflowed:
            if on_event is not None:
                on_event("link_reextract", p=p, overflowed_chunks=group_overflows[p - g * G])
            emit(p, *outofcore._reextract(
                chunk_records, n_chunks, p, extract=outofcore.extract_partition_range3,
                partitions=partitions, cap0=cap_bp, unit_records=rec_per_chunk,
                what="link"))
    if park_links:
        return next_host[: 2 * n]
    return next_state[: 2 * n]


def _jump_init(next_state: torch.Tensor, lanes: int = 2):
    """The round-0 table [2N, lanes] (parent, rank[, min id]) and pred."""
    n2 = next_state.shape[0]
    ids = torch.arange(n2, dtype=torch.int64, device=next_state.device)
    pred = torch.full((n2 + 1,), -1, dtype=torch.int64, device=next_state.device)
    pred.scatter_(0, torch.where(next_state >= 0, next_state, n2), ids)
    pred = pred[:n2]
    parent = torch.where(pred >= 0, pred, ids)
    cols = [parent, (pred >= 0).long()]
    if lanes == 3:
        cols.append(torch.minimum(ids, parent))
    return torch.stack(cols, dim=1), pred


def _jump_rows(tbl: torch.Tensor, rows: torch.Tensor):
    """One doubling step for ``rows`` of the table (a slice of it): the
    rows' new values and whether a parent moved (on the device)."""
    parent = rows[:, 0]
    g = tbl[parent]  # one row gather for every lane
    cols = [g[:, 0], rows[:, 1] + g[:, 1]]
    if tbl.shape[1] == 3:
        cols.append(torch.minimum(rows[:, 2], g[:, 2]))
    new = torch.stack(cols, dim=1)
    return new, (new[:, 0] != parent).any()


def _jump_round_lowmem(tbl: torch.Tensor, out: torch.Tensor, *, n_chunks: int):
    """One doubling round at minimum live memory: the OLD table + the NEW.

    Doubling cannot run in place (late chunks gather rows early chunks
    would have overwritten), so the floor is two tables; the gather
    temporaries are chunk-sized.  Writes ``out`` and returns (out,
    changed); callers ping-pong the two buffers across rounds.
    """
    rows = tbl.shape[0] // n_chunks
    changed = torch.zeros((), dtype=torch.bool, device=tbl.device)
    for c in range(n_chunks):
        new, moved = _jump_rows(tbl, tbl[c * rows: (c + 1) * rows])
        out[c * rows: (c + 1) * rows] = new
        changed |= moved
    return out, changed


def _jump_finish(tbl: torch.Tensor, pred: torch.Tensor, next_state: torch.Tensor):
    parent = tbl[:, 0]
    is_cycle = pred[parent] >= 0
    min_lane = tbl[:, 2] if tbl.shape[1] == 3 else parent
    head = torch.where(is_cycle, min_lane, parent)
    rank = torch.where(is_cycle, 0, tbl[:, 1])
    return CompactedGraph(next_state=next_state, head=head, rank=rank, is_cycle=is_cycle)


def pointer_jump_bulk(next_state: torch.Tensor, checkpoint_dir: str | None = None,
                      checkpoint_every: int = 4, lowmem_chunks: int | None = None,
                      on_round=None) -> CompactedGraph:
    """pointer_jump for HUGE graphs: the same result, lower peak memory.

    Each doubling round is its own step over a [2N, lanes] table (one
    row gather), and early exit reads one bool a round.  The common
    acyclic case carries TWO lanes (parent, rank); when cycles are found
    the doubling reruns once with a third lane, the cycle's minimum state
    id.

    lowmem_chunks > 0 (automatic above 2^27 states) runs the rounds in
    that many slices over two ping-ponged tables
    (``_jump_round_lowmem``); the states are padded to a multiple of it
    with self-absorbed isolates, invisible to results and to early exit.

    checkpoint_dir: every ``checkpoint_every`` rounds the table (and pred)
    is saved there (``utils/checkpoint``: the JAX package's files,
    fingerprinted against this link array), and a later call on the same
    links resumes at the last saved round.  Rounds are idempotent given
    the table, so a resumed jump equals an uninterrupted one bit for bit;
    frontiers are saved unpadded, so a lowmem and a non-lowmem run resume
    each other's.  on_round(round, seconds) runs after each round.
    """
    from genome_assembly_tpu_torch.utils import checkpoint as ckpt_mod

    n2 = next_state.shape[0]
    steps = max(1, math.ceil(math.log2(max(n2, 2))) + 1)
    if lowmem_chunks is None:
        lowmem_chunks = 8 if n2 > (1 << 27) else 0
    fp = ckpt_mod.jump_fingerprint(next_state) if checkpoint_dir is not None else None
    n2p = n2
    ns_run = next_state
    if lowmem_chunks:
        n2p = -(-n2 // lowmem_chunks) * lowmem_chunks
        if n2p != n2:
            ns_run = torch.cat([next_state, next_state.new_full((n2p - n2,), -1)])

    def pad_frontier(a: np.ndarray) -> torch.Tensor:
        """A saved frontier array on the device, padded to n2p with
        self-absorbed rows (pred: no predecessor)."""
        if a.shape[0] != n2p:
            pad_ids = np.arange(a.shape[0], n2p, dtype=np.int64)
            if a.ndim == 2:
                cols = [pad_ids, np.zeros_like(pad_ids)] + ([pad_ids] if a.shape[1] == 3 else [])
                pad = np.stack(cols, axis=1)
            else:
                pad = np.full(n2p - a.shape[0], -1, np.int64)
            a = np.concatenate([a, pad])
        return torch.from_numpy(a).to(next_state.device)

    def run(lanes):
        start, saved = 0, None
        if fp is not None:
            saved = ckpt_mod.load_jump_frontier(checkpoint_dir, lanes, fp)
        if saved is not None:
            tbl_h, pred_h, start = saved
            tbl, pred = pad_frontier(tbl_h), pad_frontier(pred_h)
            del saved, tbl_h, pred_h
        else:
            tbl, pred = _jump_init(ns_run, lanes)
        out = torch.empty_like(tbl) if lowmem_chunks else None
        for r in range(start, steps):
            t0 = time.perf_counter()
            if lowmem_chunks:
                new, changed = _jump_round_lowmem(tbl, out, n_chunks=lowmem_chunks)
                tbl, out = new, tbl
            else:
                tbl, changed = _jump_rows(tbl, tbl)
            done = not bool(changed)  # one read-back a round
            if on_round is not None:
                on_round(r, time.perf_counter() - t0)
            if fp is not None and not done and (r + 1) % checkpoint_every == 0:
                ckpt_mod.save_jump_frontier(checkpoint_dir, tbl[:n2], pred[:n2], r + 1,
                                            lanes, fp)
            if done:
                break
        del out
        graph = _jump_finish(tbl, pred, next_state)
        if n2p != n2:
            graph = CompactedGraph(next_state=next_state, head=graph.head[:n2],
                                   rank=graph.rank[:n2], is_cycle=graph.is_cycle[:n2])
        return graph

    graph = run(2)
    if bool(graph.is_cycle.any()):
        del graph  # free before the wider rerun
        graph = run(3)
    return graph


# ---------------------------------------------------------------------------
# Host side (numpy): ragged string assembly from the fixed-shape chain
# assignment.  Takes numpy arrays or tensors.
# ---------------------------------------------------------------------------

_CODE_CHARS = np.frombuffer(b"TGCA", dtype=np.uint8)


def _host(x) -> np.ndarray:
    """x as a numpy array; a tensor is read back, its bytes counted as
    ``d2h_bytes``."""
    if isinstance(x, torch.Tensor):
        out = x.detach().cpu().numpy()
        profiling.count("d2h_bytes", out.nbytes)
        return out
    return np.asarray(x)


def materialize_unitigs(kmer, valid, graph: CompactedGraph, k: int) -> List[str]:
    """Host-side unitig assembly from chain assignments.

    Vectorized in numpy: states are lexsorted by (head, rank), chain
    boundaries come from head changes, and all characters land in one flat
    byte buffer in a single pass.  Each unitig appears once: of the two
    strand traversals, the canonical (lexicographically smaller) one is
    kept; palindromic unitigs and cycle rotations are deduped explicitly.
    The ORDER of the returned list is part of the contract.
    """
    unitigs, _, _ = _materialize(kmer, valid, graph, k, None)
    return unitigs


def materialize_unitigs_cov(
    kmer, valid, graph: CompactedGraph, k: int, node_counts
) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """materialize_unitigs plus per-unitig abundance coverage.

    node_counts: per-node occurrence counts aligned with the key rows
    (count.kept_keys_sorted_with_counts).  Returns (unitigs, occ_sum,
    n_kmers): occ_sum[i] is the total occurrence count of unitig i's
    constituent canonical k-mers and n_kmers[i] their number.
    """
    return _materialize(kmer, valid, graph, k, _host(node_counts))


def _materialize_cycles(
    next_state: np.ndarray,
    head: np.ndarray,
    cyc_states: np.ndarray,
    vals_c: np.ndarray,
    k: int,
    node_counts,
) -> Tuple[List[str], List[int], List[int]]:
    """Vectorized cycle-unitig assembly.

    Ranks around each cycle come from host pointer doubling (the jump
    zeroes cycle ranks), then the same flat-buffer assembly as linear
    chains spells every traversal at once.  Twin traversals (forward and
    reverse-complement strands of one unitig cycle) are deduped by their
    minimum member NODE id -- a traversal invariant, since edge u->v
    implies rc edge v^1->u^1.  vals_c: uint64 packed values aligned with
    cyc_states.
    """
    m = cyc_states.size
    n2 = next_state.shape[0]
    comp = np.full(n2, -1, dtype=np.int64)
    comp[cyc_states] = np.arange(m, dtype=np.int64)
    nxt_c = comp[next_state[cyc_states]]
    # in/out-degree <= 1 (unitig edge rule): cycle states form pure
    # permutation cycles, never rho shapes
    assert (nxt_c >= 0).all(), "cycle state links outside the cycle set"
    head_c = head[cyc_states].astype(np.int64)
    is_head = cyc_states == head_c
    pred_c = np.empty(m, dtype=np.int64)
    pred_c[nxt_c] = np.arange(m, dtype=np.int64)
    # head-absorbing predecessor doubling: rank[s] = distance from the
    # cycle's head (min state id) to s along next_state
    parent = np.where(is_head, np.arange(m, dtype=np.int64), pred_c)
    crank = (~is_head).astype(np.int64)
    while True:
        crank = crank + crank[parent]
        new_parent = parent[parent]
        if np.array_equal(new_parent, parent):
            break
        parent = new_parent

    order_c = np.lexsort((crank, head_c))
    s_c = cyc_states[order_c]  # global state ids in walk order
    v_c = vals_c[order_c]
    h_c = head_c[order_c]
    r_c = crank[order_c]
    start_mask = np.empty(m, dtype=bool)
    start_mask[0] = True
    start_mask[1:] = h_c[1:] != h_c[:-1]
    startsc = np.flatnonzero(start_mask)
    lens_c = np.diff(np.append(startsc, m))
    # one traversal per unitig cycle: first chain in ascending head order
    # per min-member-node key
    min_node = np.minimum.reduceat(s_c >> 1, startsc)
    _, first_idx = np.unique(min_node, return_index=True)
    keep_idx = np.sort(first_idx)
    k_lens = lens_c[keep_idx]
    out_lens_c = k_lens + (k - 1)
    off_c = np.zeros(len(keep_idx) + 1, dtype=np.int64)
    np.cumsum(out_lens_c, out=off_c[1:])
    buf_c = np.empty(off_c[-1], dtype=np.uint8)
    first_vals = v_c[startsc[keep_idx]]
    for j in range(k):
        shift = np.uint64(2 * (k - 1 - j))
        buf_c[off_c[:-1] + j] = _CODE_CHARS[
            ((first_vals >> shift) & np.uint64(3)).astype(np.int64)
        ]
    chain_id_c = np.cumsum(start_mask) - 1
    kept_pos = np.full(len(startsc), -1, dtype=np.int64)
    kept_pos[keep_idx] = np.arange(len(keep_idx))
    sel = (kept_pos[chain_id_c] >= 0) & ~start_mask
    pos_c = off_c[kept_pos[chain_id_c[sel]]] + (k - 1) + r_c[sel]
    buf_c[pos_c] = _CODE_CHARS[(v_c[sel] & np.uint64(3)).astype(np.int64)]
    all_bytes_c = buf_c.tobytes()
    cycle_strings = [
        all_bytes_c[off_c[i] : off_c[i + 1]].decode()
        for i in range(len(keep_idx))
    ]
    cycle_sums: List[int] = []
    cycle_lens: List[int] = []
    if node_counts is not None:
        sums_all = np.add.reduceat(
            node_counts[s_c >> 1].astype(np.int64), startsc
        )
        cycle_sums = [int(x) for x in sums_all[keep_idx]]
        cycle_lens = [int(x) for x in k_lens]
    return cycle_strings, cycle_sums, cycle_lens


def _canonical_chain_strings(
    all_bytes: bytes,
    out_off: np.ndarray,
    chain_lens: np.ndarray,
    chain_sums,
    cycle_strings: List[str],
    cycle_sums: List[int],
    cycle_lens: List[int],
) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Strand-canonicalize linear chains (keep the lexicographically
    smaller of the two strand spellings; dedup palindromes) and append
    the cycle results."""
    unitigs: List[str] = []
    occ_sums: List[int] = []
    n_kmers: List[int] = []
    seen_palindromes = set()
    for c in range(len(out_off) - 1):
        u = all_bytes[out_off[c] : out_off[c + 1]].decode()
        rc_u = _rc_str(u)
        if u == rc_u:
            # palindromic unitig: both strand chains spell the same string;
            # keep exactly one (whole unitigs of even length can be
            # palindromic even though odd-k k-mers cannot)
            if u in seen_palindromes:
                continue
            seen_palindromes.add(u)
        elif u >= rc_u:
            continue
        unitigs.append(u)
        if chain_sums is not None:
            occ_sums.append(int(chain_sums[c]))
            n_kmers.append(int(chain_lens[c]))
    unitigs.extend(cycle_strings)
    occ_sums.extend(cycle_sums)
    n_kmers.extend(cycle_lens)
    return (
        unitigs,
        np.asarray(occ_sums, dtype=np.int64),
        np.asarray(n_kmers, dtype=np.int64),
    )


def _materialize(
    kmer, valid, graph: CompactedGraph, k: int, node_counts
) -> Tuple[List[str], np.ndarray, np.ndarray]:
    with profiling.span("readback"):
        # the int64 key IS the full 2k-bit packed value
        value = _host(kmer).astype(np.uint64)
        valid = _host(valid)
        next_state = _host(graph.next_state)
        head = _host(graph.head)
        rank = _host(graph.rank).astype(np.int64)
        is_cycle = _host(graph.is_cycle)

    n = value.shape[0]
    kmask = (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)

    def rc_val(v):
        out = np.zeros_like(v)
        comp = kmask - v  # complement per 2-bit group == mask - v
        for j in range(k):
            out = (out << np.uint64(2)) | ((comp >> np.uint64(2 * j)) & np.uint64(3))
        return out

    with profiling.span("revcomp"):
        state_val = np.empty(2 * n, dtype=np.uint64)
        state_val[0::2] = value
        state_val[1::2] = rc_val(value)
        node_valid = np.repeat(valid, 2)

    with profiling.span("cycles"):
        cyc_states = np.flatnonzero(is_cycle & node_valid)
        if cyc_states.size:
            cycle_strings, cycle_sums, cycle_lens = _materialize_cycles(
                next_state, head, cyc_states, state_val[cyc_states], k,
                node_counts,
            )
        else:
            cycle_strings, cycle_sums, cycle_lens = [], [], []

    # --- linear chains: vectorized assembly ---
    with profiling.span("sort"):
        lin_mask = node_valid & ~is_cycle
        lin_states = np.flatnonzero(lin_mask)
        if lin_states.size == 0:
            return (
                cycle_strings,
                np.asarray(cycle_sums, dtype=np.int64),
                np.asarray(cycle_lens, dtype=np.int64),
            )

        order = np.lexsort((rank[lin_states], head[lin_states]))
        s_sorted = lin_states[order]
        h_sorted = head[lin_states][order]
        chain_start = np.empty(len(s_sorted), dtype=bool)
        chain_start[0] = True
        chain_start[1:] = h_sorted[1:] != h_sorted[:-1]
        starts = np.flatnonzero(chain_start)
        chain_lens = np.diff(np.append(starts, len(s_sorted)))
        out_lens = chain_lens + (k - 1)

    with profiling.span("spell"):
        # flat byte buffer: chain c occupies [out_off[c], out_off[c] + out_lens[c])
        out_off = np.zeros(len(starts) + 1, dtype=np.int64)
        np.cumsum(out_lens, out=out_off[1:])
        buf = np.empty(out_off[-1], dtype=np.uint8)

        # first k characters of each chain: decode the head state's value
        first_vals = state_val[s_sorted[starts]]
        for j in range(k):
            shift = np.uint64(2 * (k - 1 - j))
            buf[out_off[:-1] + j] = _CODE_CHARS[
                ((first_vals >> shift) & np.uint64(3)).astype(np.int64)
            ]
        # subsequent states contribute their last base at position k-1+rank
        chain_id = np.cumsum(chain_start) - 1
        not_first = ~chain_start
        pos = out_off[chain_id[not_first]] + (k - 1) + rank[s_sorted[not_first]]
        buf[pos] = _CODE_CHARS[
            (state_val[s_sorted[not_first]] & np.uint64(3)).astype(np.int64)
        ]

        # per-chain coverage: occurrence counts summed over member nodes
        chain_sums = None
        if node_counts is not None:
            chain_sums = np.add.reduceat(
                node_counts[s_sorted >> 1].astype(np.int64), starts
            )
        all_bytes = buf.tobytes()

    with profiling.span("strands"):
        return _canonical_chain_strings(
            all_bytes, out_off, chain_lens, chain_sums,
            cycle_strings, cycle_sums, cycle_lens,
        )


_ASCII_TGCA = torch.tensor(list(b"TGCA"), dtype=torch.uint8)
_NO_WALK = torch.iinfo(torch.int64).max
# the walk sort packs a state id and a rank into one int64 (31 bits each)
MAX_WALK_STATES = 1 << 31


def _count_cycle_nodes(valid: torch.Tensor, is_cycle: torch.Tensor) -> torch.Tensor:
    """Valid cycle states (a device scalar)."""
    return (is_cycle & valid.repeat_interleave(2)).sum()


def _materialize_prep_sort(valid, head, rank, is_cycle):
    """Device walk sort for ``materialize_unitigs_device``.

    Sorts the linear valid states into (head, rank) walk order with ONE
    int64 sort on ``head << 32 | rank`` (the caller holds state ids and
    ranks below 2^31: ``MAX_WALK_STATES``); invalid and cycle rows sort
    to a tail.  Returns (sid_s,
    chain_start, n_lin) -- n_lin a device scalar.  (head, rank) is unique
    among linear states, so the order is fully determined.
    """
    lin = valid.repeat_interleave(2) & ~is_cycle
    key_s, sid_s = torch.sort(torch.where(lin, (head << 32) | rank, _NO_WALK))
    h_s = key_s >> 32
    chain_start = torch.ones_like(lin)
    chain_start[1:] = h_s[1:] != h_s[:-1]
    walk = key_s != _NO_WALK
    return sid_s, chain_start & walk, walk.sum()


def _materialize_prep_bytes(kmer: torch.Tensor, sid_s: torch.Tensor, *, k: int) -> torch.Tensor:
    """Each state's output byte in walk order: its value's last base as
    ASCII.  A forward state ends in ``kmer & 3``; a reverse state in the
    complement of the forward k-mer's FIRST base (complement == 3 - code
    in the T=0 G=1 C=2 A=3 encoding)."""
    kv = kmer[sid_s >> 1]
    first_code = (kv >> (2 * k - 2)) & 3
    code = torch.where((sid_s & 1) == 0, kv & 3, 3 - first_code)
    return _ASCII_TGCA.to(kmer.device)[code]


def _host_state_vals(kmer, k: int, sids: np.ndarray) -> np.ndarray:
    """uint64 packed 2k-bit values of the given STATE ids (node = sid >> 1,
    odd sid = reverse complement), for just those states: the nodes' keys
    are gathered where ``kmer`` lies and only they come to the host."""
    node = torch.from_numpy(np.asarray(sids, dtype=np.int64) >> 1)
    if isinstance(kmer, torch.Tensor):
        profiling.count("h2d_bytes", node.nbytes)
        v = _host(kmer[node.to(kmer.device)]).astype(np.uint64)
    else:
        v = np.asarray(kmer)[node.numpy()].astype(np.uint64)
    odd = (np.asarray(sids) & 1).astype(bool)
    if odd.any():
        kmask = (np.uint64(1) << np.uint64(2 * k)) - np.uint64(1)
        comp = kmask - v[odd]  # complement per 2-bit group == mask - v
        out = np.zeros_like(comp)
        for j in range(k):
            out = (out << np.uint64(2)) | ((comp >> np.uint64(2 * j)) & np.uint64(3))
        v[odd] = out
    return v


def materialize_unitigs_device(
    kmer, valid, graph: CompactedGraph, k: int, node_counts=None
) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """materialize_unitigs(_cov) with the heavy steps on the device.

    The host materializer reads the whole graph back, runs a k-step
    reverse complement over all 2N values and lexsorts 2N states.  Here
    the walk sort and each state's output byte run on the device; the
    host reads back one byte a linear state, the chain starts and their
    head states' keys (the k-step reverse complement runs for chain heads
    only), then places the bytes in one vectorized pass.  Cycles take the
    shared host cycle path.  Same output as ``materialize_unitigs`` /
    ``materialize_unitigs_cov``, same order.

    Returns (unitigs, occ_sums, n_kmers); the count arrays are empty when
    node_counts is None.
    """
    device = graph.head.device
    if graph.head.shape[0] > MAX_WALK_STATES:
        raise ValueError(
            f"{graph.head.shape[0]} states: the device walk sort packs state ids "
            f"and ranks into one int64 and takes at most {MAX_WALK_STATES}")
    if not (isinstance(kmer, torch.Tensor) and kmer.device == device):
        kmer = torch.as_tensor(kmer)
        profiling.count("h2d_bytes", kmer.nbytes)
    if not (isinstance(valid, torch.Tensor) and valid.device == device):
        valid = torch.as_tensor(valid)
        profiling.count("h2d_bytes", valid.nbytes)
    kmer, valid = kmer.to(device), valid.to(device)
    cycle_strings: List[str] = []
    cycle_sums: List[int] = []
    cycle_lens: List[int] = []
    with profiling.span("cycles"):
        n_cyc = int(_count_cycle_nodes(valid, graph.is_cycle))
        if n_cyc:
            cyc_states = _host(torch.nonzero(
                graph.is_cycle & valid.repeat_interleave(2)).reshape(-1))
            cycle_strings, cycle_sums, cycle_lens = _materialize_cycles(
                _host(graph.next_state), _host(graph.head), cyc_states,
                _host_state_vals(kmer, k, cyc_states), k,
                None if node_counts is None else _host(node_counts),
            )

    with profiling.span("sort"):
        sid_s, chain_start, n_lin = _materialize_prep_sort(
            valid, graph.head, graph.rank, graph.is_cycle)
        n_lin = int(n_lin)
    if n_lin == 0:
        return (cycle_strings, np.asarray(cycle_sums, dtype=np.int64),
                np.asarray(cycle_lens, dtype=np.int64))
    with profiling.span("readback"):
        sid_s, chain_start = sid_s[:n_lin], chain_start[:n_lin]
        byte_np = _host(_materialize_prep_bytes(kmer, sid_s, k=k))
        if node_counts is None:
            # thin read-back: the byte lane, and the chain starts with their
            # head states (O(chains) ints); chain geometry from starts alone
            starts_dev = torch.nonzero(chain_start).reshape(-1)
            starts = _host(starts_dev)
            head_sids = _host(sid_s[starts_dev])
            sid_np = None
        else:
            # coverage needs every state's node count: the state lane comes back
            sid_np = _host(sid_s)
            starts = np.flatnonzero(_host(chain_start))
            head_sids = sid_np[starts]

    # a head state gives the chain its first k-1 bases; its LAST base comes
    # through the byte lane like every other state's
    with profiling.span("revcomp"):
        first_vals = _host_state_vals(kmer, k, head_sids)
    with profiling.span("spell"):
        n_chains = len(starts)
        chain_lens = np.diff(np.append(starts, n_lin))
        out_off = np.zeros(n_chains + 1, dtype=np.int64)
        np.cumsum(chain_lens + (k - 1), out=out_off[1:])
        buf = np.empty(out_off[-1], dtype=np.uint8)
        for j in range(k - 1):
            shift = np.uint64(2 * (k - 1 - j))
            buf[out_off[:-1] + j] = _CODE_CHARS[
                ((first_vals >> shift) & np.uint64(3)).astype(np.int64)
            ]
        chain_id = np.repeat(np.arange(n_chains, dtype=np.int64), chain_lens)
        local_i = np.arange(n_lin, dtype=np.int64) - starts[chain_id]
        buf[out_off[chain_id] + (k - 1) + local_i] = byte_np

        chain_sums = None
        if node_counts is not None:
            chain_sums = np.add.reduceat(
                _host(node_counts)[sid_np >> 1].astype(np.int64), starts)
        all_bytes = buf.tobytes()
    with profiling.span("strands"):
        return _canonical_chain_strings(
            all_bytes, out_off, chain_lens, chain_sums,
            cycle_strings, cycle_sums, cycle_lens,
        )


def materialize_unitigs_partitioned(kmer, valid, graph: CompactedGraph, k: int,
                                    partitions: int = 8) -> List[str]:
    """materialize_unitigs with bounded host memory a bucket (host numpy).

    Chains are bucketed by a multiplicative hash of their head id (a chain
    is atomic under head bucketing) and each bucket runs the flat-buffer
    placement over its own states only, so the host memory past the inputs
    is O(total / partitions).  Cycles take the shared cycle path first,
    unbucketed.  Palindromic twins are deduped by the chain-invariant rule
    "emit from the twin whose head id is smaller", so no bucket needs
    another's output.  The same output SET as ``materialize_unitigs``; the
    order is the JAX package's (cycles, then bucket by bucket).
    """
    value = _host(kmer).astype(np.uint64)
    valid = _host(valid)
    head = _host(graph.head)
    rank = _host(graph.rank).astype(np.int64)
    is_cycle = _host(graph.is_cycle)
    node_valid = np.repeat(valid, 2)

    out: List[str] = []
    cyc_states = np.flatnonzero(is_cycle & node_valid)
    if cyc_states.size:
        cs, _, _ = _materialize_cycles(
            _host(graph.next_state), head, cyc_states,
            _host_state_vals(kmer, k, cyc_states), k, None)
        out.extend(cs)

    lin_states = np.flatnonzero(node_valid & ~is_cycle)
    if lin_states.size == 0:
        return out
    hb = (head[lin_states].astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
          >> np.uint64(40)) % np.uint64(partitions)
    for b in range(partitions):
        sel = lin_states[hb == np.uint64(b)]
        if sel.size == 0:
            continue
        order = np.lexsort((rank[sel], head[sel]))
        s_sorted = sel[order]
        h_sorted = head[sel][order]
        chain_start = np.empty(len(s_sorted), dtype=bool)
        chain_start[0] = True
        chain_start[1:] = h_sorted[1:] != h_sorted[:-1]
        starts = np.flatnonzero(chain_start)
        chain_lens = np.diff(np.append(starts, len(s_sorted)))
        out_off = np.zeros(len(starts) + 1, dtype=np.int64)
        np.cumsum(chain_lens + (k - 1), out=out_off[1:])
        buf = np.empty(out_off[-1], dtype=np.uint8)

        # each state's LAST base: a forward state's is ``value & 3``, a
        # reverse state's the complement (3 - code) of the key's FIRST base
        v = value[s_sorted >> 1]
        first_code = (v >> np.uint64(2 * k - 2)) & np.uint64(3)
        code = np.where((s_sorted & 1) == 0, v & np.uint64(3), np.uint64(3) - first_code)
        # a head state gives its chain's first k-1 bases; its last base
        # comes through the byte lane like every other state's
        head_sids = s_sorted[starts]
        first_vals = _host_state_vals(kmer, k, head_sids)
        for j in range(k - 1):
            shift = np.uint64(2 * (k - 1 - j))
            buf[out_off[:-1] + j] = _CODE_CHARS[
                ((first_vals >> shift) & np.uint64(3)).astype(np.int64)]
        chain_id = np.cumsum(chain_start) - 1
        local_i = np.arange(len(s_sorted), dtype=np.int64) - starts[chain_id]
        buf[out_off[chain_id] + (k - 1) + local_i] = _CODE_CHARS[code.astype(np.int64)]

        # the twin chain's head is this chain's last state ^ 1: the
        # palindrome tiebreak needs no other bucket
        last_sids = s_sorted[starts + chain_lens - 1]
        data = buf.tobytes()
        for c in range(len(starts)):
            u = data[out_off[c]: out_off[c + 1]].decode()
            rc_u = _rc_str(u)
            if u > rc_u:
                continue
            if u == rc_u and not int(head_sids[c]) < int(last_sids[c] ^ 1):
                continue
            out.append(u)
    return out


_CHAR_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate(b"TGCA"):
    _CHAR_CODE[_c] = _i


def unitig_member_nodes(
    kmer, unitigs: List[str], k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """CSR of each unitig's constituent canonical k-mer rows.

    kmer: the sorted node keys the graph was built over.  Returns
    (offsets [n_unitigs + 1], node_rows): unitig i's k-mers are the rows
    node_rows[offsets[i]:offsets[i+1]], in walk order.  Per unitig, the
    window values come from k shift-and-or passes over its code array and
    a binary search; every window must be present in the node table -- a
    self-check that the materialized strings spell paths in the dBG.
    """
    packed = _host(kmer).astype(np.uint64)

    offsets = np.zeros(len(unitigs) + 1, dtype=np.int64)
    rows_parts = []
    for i, u in enumerate(unitigs):
        codes = _CHAR_CODE[np.frombuffer(u.encode(), dtype=np.uint8)].astype(
            np.uint64
        )
        if codes.size < k:
            raise ValueError(f"unitig shorter than k: {u!r}")
        nwin = codes.size - k + 1
        fwd = np.zeros(nwin, dtype=np.uint64)
        rev = np.zeros(nwin, dtype=np.uint64)
        for j in range(k):
            c = codes[j : j + nwin]
            fwd = (fwd << np.uint64(2)) | c
            rev |= (np.uint64(3) - c) << np.uint64(2 * j)
        canon = np.minimum(fwd, rev)
        pos = np.searchsorted(packed, canon)
        ok = (pos < packed.size) & (packed[np.minimum(pos, packed.size - 1)] == canon)
        if not ok.all():
            raise AssertionError(
                f"unitig {i} contains k-mers absent from the node table"
            )
        rows_parts.append(pos.astype(np.int64))
        offsets[i + 1] = offsets[i] + pos.size
    rows = (
        np.concatenate(rows_parts)
        if rows_parts
        else np.zeros(0, dtype=np.int64)
    )
    return offsets, rows


_RC_TABLE = str.maketrans("ACGT", "TGCA")


def _rc_str(s: str) -> str:
    return s.translate(_RC_TABLE)[::-1]

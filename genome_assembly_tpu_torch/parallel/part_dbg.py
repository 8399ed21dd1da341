"""Partitioned dBG compaction: the routed link join and the routed jump.

No replicated tables:

  - The global sorted key array is split into equal contiguous row ranges;
    shard ``s`` owns rows ``[s*rows, (s+1)*rows)`` and their states
    ``[2*s*rows, 2*(s+1)*rows)``.
  - Links: every state emits an OUT record keyed by its suffix and an IN
    record keyed by its prefix ((k-1)-mers); the records go to the key's
    HASH owner, one local sort there pair-tests adjacent rows (all records
    of one (k-1)-mer land on one shard), and each edge goes home to its
    source state's shard.  The distributed form of
    ops/dbg.build_unitig_links_join: no table lookups.
  - Pointer jumping gathers (parent, rank, min) by global state id from the
    owner of the id's row range, with requests deduplicated a shard before
    routing (chains converge on few heads as doubling proceeds).

Every routing step reports an overflow count instead of dropping in
silence; results hold only when every count is zero (re-run with more
``slack``).

Sharded inputs and outputs are lists with one tensor a local shard
(``ShardMesh.shard_rows`` splits a whole array).  State ids and ranks are
int64, so the JAX package's wide (owner, local) forms, for past 2**31
states, are these same functions here.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from genome_assembly_tpu_torch.common import LINK_HASH_A, LINK_HASH_B, SENTINEL
from genome_assembly_tpu_torch.ops import dbg, encode
from genome_assembly_tpu_torch.ops import outofcore

# link record payload: side << 62 | state (as ops/dbg.py's out-of-core join)
_SIDE_SHIFT = 62
_STATE_MASK = (1 << _SIDE_SHIFT) - 1


# ---------------------------------------------------------------------------
# routing primitives (one shard's tensors)
# ---------------------------------------------------------------------------


def _pack_by_owner(owner, active, payloads, fills, n_shards: int, cap: int):
    """Sort this shard's records by owner (stable) and place them in
    ``[n_shards, cap, L]`` capacity blocks: block ``j`` holds, in order,
    the first ``cap`` active records owned by shard ``j``; the rest of a
    block is ``fills``.  Returns (blocks, overflow): records past a
    block's capacity are dropped and counted."""
    key = torch.where(active, owner, n_shards)
    key_s, idx_s = torch.sort(key, stable=True)
    counts = torch.bincount(key_s, minlength=n_shards + 1)[:n_shards]
    starts = torch.cumsum(counts, 0) - counts
    c = torch.arange(cap, device=owner.device)
    src = (starts[:, None] + c[None, :]).clamp(max=max(key_s.shape[0] - 1, 0))
    placed = c[None, :] < counts[:, None]
    rows = idx_s[src]
    lanes = [torch.where(placed, p[rows], fill) for p, fill in zip(payloads, fills)]
    return torch.stack(lanes, dim=2), (counts - cap).clamp(min=0).sum()


def _key_owner(key: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Shard of a (k-1)-mer boundary key: the LINK hash constants, so a
    T-leading k-mer (which packs to its own suffix) does not share the
    count phase's owner."""
    return (outofcore._mix_key(key, LINK_HASH_A, LINK_HASH_B) >> 7) % n_shards


def _boundary_records(kmer_l, valid_l, *, k: int, gid):
    """The 4 boundary records of each of this shard's nodes: OUT rows
    keyed by the oriented suffix, IN rows by the oriented prefix, payload
    ``side << 62 | state``.  States are strand-major (all strand-0 states,
    then strand 1); ``gid`` gives their ids in that order.  Returns (key,
    payload, active)."""
    oriented = torch.cat([kmer_l, encode.reverse_complement_packed(kmer_l, k)])
    state_valid = torch.cat([valid_l, valid_l])
    key = torch.cat([oriented & ((1 << (2 * k - 2)) - 1), oriented >> 2])
    payload = torch.cat([gid, gid | (1 << _SIDE_SHIFT)])
    return key, payload, torch.cat([state_valid, state_valid])


def _pair_edges(r_key, r_pay):
    """Sort the received boundary records by (key, payload) and pair-test
    adjacent rows: a key group of exactly one OUT and one IN row is a unitig
    edge.  Returns (edge mask, source state, target state) in sorted order;
    hairpins (target == source ^ 1) are excluded."""
    order = torch.sort(r_pay, stable=True).indices
    order = order[torch.sort(r_key[order], stable=True).indices]
    key_s, pay_s = r_key[order], r_pay[order]
    valid_s = key_s != SENTINEL
    side_s = pay_s >> _SIDE_SHIFT
    state_s = pay_s & _STATE_MASK
    fill = SENTINEL ^ 1
    same_next = dbg._shift_next(key_s, fill) == key_s
    same_prev = dbg._shift_prev(key_s, fill) == key_s
    pair = (~same_prev & same_next & ~dbg._shift_next(same_next, True)
            & (side_s == 0) & (dbg._shift_next(side_s, 1) == 1) & valid_s)
    target = dbg._shift_next(state_s, -1)
    return pair & ~(target == (state_s ^ 1)), state_s, target


def _routed_gather(tables: Sequence[Sequence[torch.Tensor]], parent: Sequence[torch.Tensor],
                   *, rows: int, mesh, cap: int):
    """``tables[t][parent]`` for global indices ``parent``, owner-routed,
    with each shard's duplicate requests combined into one.

    tables: a local shard's list of [rows] int64 tables, one list a local
    shard; parent: one [q] tensor of in-range global indices a local
    shard.  Returns (one [q, T] tensor a local shard, one overflow count a
    local shard)."""
    n_shards = mesh.n_shards
    # the tables packed once: one row gather answers every table
    tstacks = [torch.stack(list(tabs), dim=1) for tabs in tables]
    state, qbufs, overflow = [], [], []
    for s, par in zip(mesh.local, parent):
        q = par.shape[0]
        idx = torch.arange(q, device=par.device)
        par_s, idx_s = torch.sort(par, stable=True)
        gs = torch.ones(q, dtype=torch.bool, device=par.device)
        gs[1:] = par_s[1:] != par_s[:-1]
        owner = par_s // rows
        is_local = owner == s
        # slot = rank among the routed (remote) group heads of this owner
        act = gs & ~is_local
        c = torch.cumsum(act, 0)
        run_start = torch.searchsorted(
            owner, torch.arange(n_shards, device=par.device), side="left")
        run_before = (c - act.long())[run_start[owner.clamp(0, n_shards - 1)].clamp(max=q - 1)]
        slot = c - 1 - run_before
        ok = act & (slot < cap)
        overflow.append((act & (slot >= cap)).sum())
        qbuf = par.new_full((n_shards, cap), -1)
        qbuf[owner[ok], slot[ok]] = par_s[ok]
        qbufs.append(qbuf)
        state.append((par_s, idx_s, gs, owner, is_local, ok, slot, idx))
    recv = mesh.all_to_all(qbufs)
    answers = []
    for s, r, tstack in zip(mesh.local, recv, tstacks):
        r = r.reshape(-1)
        got = torch.where((r >= 0)[:, None], tstack[(r - s * rows).clamp(0, rows - 1)], 0)
        answers.append(got.reshape(n_shards, -1, tstack.shape[1]))
    back = mesh.all_to_all(answers)
    out = []
    for s, b, tstack, st in zip(mesh.local, back, tstacks, state):
        par_s, idx_s, gs, owner, is_local, ok, slot, idx = st
        at_heads = torch.where(
            ok[:, None], b[owner.clamp(0, n_shards - 1), slot.clamp(0, cap - 1)], 0)
        local_heads = is_local & gs
        at_heads[local_heads] = tstack[par_s[local_heads] - s * rows]
        head_pos = torch.cummax(torch.where(gs, idx, -1), 0).values
        got = torch.empty_like(at_heads)
        got[idx_s] = at_heads[head_pos]
        out.append(got)
    return out, overflow


# ---------------------------------------------------------------------------
# the routed sort-join
# ---------------------------------------------------------------------------


def _rows(shards: Sequence[torch.Tensor]) -> int:
    rows = shards[0].shape[0]
    if any(x.shape[0] != rows for x in shards):
        raise ValueError("every shard must hold the same number of rows")
    return rows


def partitioned_unitig_links_join(kmer: Sequence[torch.Tensor], valid: Sequence[torch.Tensor],
                                  *, k: int, mesh, slack: float = 4.0):
    """next_state via the routed (k-1)-mer sort-join, fully partitioned.

    kmer, valid: the globally sorted canonical keys (SENTINEL-padded) cut
    into the mesh's row blocks, one [rows] tensor a local shard.  Returns
    (next_state, overflow): one [2*rows] int64 tensor a local shard (its
    states ``2*node + strand``, ``-1`` = no unitig edge) and one count a
    shard.  Equal to ``dbg.build_unitig_links_join`` over the whole array.
    """
    if k % 2 == 0:
        raise ValueError("fast-mode dBG requires odd k")
    n_shards = mesh.n_shards
    rows = _rows(kmer)
    if 2 * rows * n_shards >= 1 << 62:
        raise ValueError("too many states for the (side, state) record payload")
    # 4*rows records a shard, hash-spread over n_shards owners
    cap_rec = max(1, int(np.ceil(4 * rows / n_shards * slack)))
    # at most one edge a state routed home
    cap_edge = max(1, int(np.ceil(2 * rows / n_shards * slack)))

    blocks, ovf_rec = [], []
    for s, kmer_l, valid_l in zip(mesh.local, kmer, valid):
        g0 = 2 * (s * rows + torch.arange(rows, device=kmer_l.device))
        key, payload, active = _boundary_records(kmer_l, valid_l, k=k,
                                                 gid=torch.cat([g0, g0 + 1]))
        b, ovf = _pack_by_owner(_key_owner(key, n_shards), active, (key, payload),
                                (SENTINEL, -1), n_shards, cap_rec)
        blocks.append(b)
        ovf_rec.append(ovf)
    received = mesh.all_to_all(blocks)
    del blocks
    eblocks, ovf_edge = [], []
    for r in received:
        r = r.reshape(-1, 2)
        edge, state_s, target = _pair_edges(r[:, 0], r[:, 1])
        # route each edge home (at most one OUT record a state: unique)
        home = state_s.clamp(0, 2 * rows * n_shards - 1) // (2 * rows)
        b, ovf = _pack_by_owner(home, edge, (state_s, target), (-1, -1), n_shards, cap_edge)
        eblocks.append(b)
        ovf_edge.append(ovf)
    del received
    links = []
    for s, b, kmer_l in zip(mesh.local, mesh.all_to_all(eblocks), kmer):
        b = b.reshape(-1, 2)
        got = b[:, 0] >= 0
        next_l = torch.full((2 * rows,), -1, dtype=torch.int64, device=kmer_l.device)
        next_l[b[got, 0] - 2 * s * rows] = b[got, 1]
        links.append(next_l)
    return links, [a + b for a, b in zip(ovf_rec, ovf_edge)]


# ---------------------------------------------------------------------------
# the routed jump
# ---------------------------------------------------------------------------


def jump_rounds(n2: int) -> int:
    """Doubling rounds of the sharded jumps (fixed, as in the JAX package)."""
    return max(1, int(np.ceil(np.log2(max(n2, 2)))) + 1)


def partitioned_pointer_jump(next_state: Sequence[torch.Tensor], *, mesh, slack: float = 4.0):
    """List ranking with states, links and per-round gathers all sharded.

    next_state: one [rows2] int64 tensor a local shard (its states' unitig
    successors, global ids).  Returns (CompactedGraph whose fields are
    lists with one [rows2] tensor a local shard, overflow one count a
    shard).  Results hold only when every overflow count is zero."""
    n_shards = mesh.n_shards
    rows2 = _rows(next_state)
    n2 = rows2 * n_shards
    cap = max(1, int(np.ceil(rows2 / n_shards * slack)))

    # predecessor table: (dest = next, src = gid) goes to dest's owner
    blocks, ovf_pred, local_pred = [], [], []
    for s, nxt in zip(mesh.local, next_state):
        gids = s * rows2 + torch.arange(rows2, device=nxt.device)
        owner = nxt.clamp(0, n2 - 1) // rows2
        is_local = (nxt >= 0) & (owner == s)
        b, ovf = _pack_by_owner(owner, (nxt >= 0) & ~is_local, (nxt, gids), (-1, -1),
                                n_shards, cap)
        blocks.append(b)
        ovf_pred.append(ovf)
        local_pred.append((nxt[is_local] - s * rows2, gids[is_local]))
    parent, rank, min_id, pred = [], [], [], []
    for s, r, (loc, src), nxt in zip(mesh.local, mesh.all_to_all(blocks), local_pred,
                                     next_state):
        r = r.reshape(-1, 2)
        got = r[:, 0] >= 0
        pred_l = torch.full((rows2,), -1, dtype=torch.int64, device=nxt.device)
        # in-degree <= 1: the destinations are globally unique
        pred_l[loc] = src
        pred_l[r[got, 0] - s * rows2] = r[got, 1]
        gids = s * rows2 + torch.arange(rows2, device=nxt.device)
        par = torch.where(pred_l >= 0, pred_l, gids)
        pred.append(pred_l)
        parent.append(par)
        rank.append((pred_l >= 0).long())
        min_id.append(torch.minimum(gids, par))

    ovf = list(ovf_pred)
    for _ in range(jump_rounds(n2)):
        got, ovf_r = _routed_gather(
            [(p, r, mi) for p, r, mi in zip(parent, rank, min_id)], parent,
            rows=rows2, mesh=mesh, cap=cap)
        rank = [r + g[:, 1] for r, g in zip(rank, got)]
        min_id = [torch.minimum(mi, g[:, 2]) for mi, g in zip(min_id, got)]
        parent = [g[:, 0] for g in got]
        ovf = [a + b for a, b in zip(ovf, ovf_r)]

    got, ovf_f = _routed_gather([(p,) for p in pred], parent, rows=rows2, mesh=mesh, cap=cap)
    is_cycle = [g[:, 0] >= 0 for g in got]
    head = [torch.where(c, mi, p) for c, mi, p in zip(is_cycle, min_id, parent)]
    # ranks on cycles depend on the round count: zero them, as every jump does
    rank = [torch.where(c, 0, r) for c, r in zip(is_cycle, rank)]
    graph = dbg.CompactedGraph(next_state=list(next_state), head=head, rank=rank,
                               is_cycle=is_cycle)
    return graph, [a + b for a, b in zip(ovf, ovf_f)]

"""Sharded pointer jumping over a replicated table.

The states (2 per node) are sharded across the mesh; every doubling round
all-gathers each shard's (parent, rank, min) rows into the whole table and
each shard gathers its own states' rows from it in one row gather.  The
form the fast-mode mesh path uses below 2**31 states; the routed jump
(parallel/part_dbg.py) keeps nothing replicated.
"""

from __future__ import annotations

from typing import Sequence

import torch

from genome_assembly_tpu_torch.ops import dbg
from genome_assembly_tpu_torch.parallel.part_dbg import _rows, jump_rounds


def sharded_pointer_jump(next_state: Sequence[torch.Tensor], *, mesh) -> dbg.CompactedGraph:
    """Pointer doubling with the state axis sharded.

    next_state: one [rows2] int64 tensor a local shard (global ids).
    Returns a CompactedGraph whose fields are lists with one [rows2] tensor
    a local shard, equal to ``dbg.pointer_jump`` of the whole array.  Runs
    a fixed ``ceil(log2(n2)) + 1`` rounds; cycle ranks are zeroed, so the
    result does not depend on the round count."""
    rows2 = _rows(next_state)
    n2 = rows2 * mesh.n_shards
    full = mesh.all_gather(next_state)
    # one predecessor table a device: local shards on one device share it
    preds = {}
    for nxt in full:
        if id(nxt) not in preds:
            ids = torch.arange(n2, device=nxt.device)
            pred = torch.full_like(ids, -1)
            src = torch.nonzero(nxt >= 0).reshape(-1)
            pred[nxt[src]] = src
            preds[id(nxt)] = pred
    pred_full = [preds[id(nxt)] for nxt in full]
    del full, preds

    tbl = []
    for s, pred in zip(mesh.local, pred_full):
        ids = s * rows2 + torch.arange(rows2, device=pred.device)
        p = pred[ids]
        parent = torch.where(p >= 0, p, ids)
        tbl.append(torch.stack([parent, (p >= 0).long(), torch.minimum(ids, parent)], dim=1))
    for _ in range(jump_rounds(n2)):
        whole = mesh.all_gather(tbl)
        tbl = [
            torch.stack([g[:, 0], t[:, 1] + g[:, 1], torch.minimum(t[:, 2], g[:, 2])], dim=1)
            for t, g in ((t, w[t[:, 0]]) for t, w in zip(tbl, whole))
        ]
        del whole
    head, rank, is_cycle = [], [], []
    for t, pred in zip(tbl, pred_full):
        cyc = pred[t[:, 0]] >= 0
        is_cycle.append(cyc)
        head.append(torch.where(cyc, t[:, 2], t[:, 0]))
        rank.append(torch.where(cyc, 0, t[:, 1]))
    return dbg.CompactedGraph(next_state=list(next_state), head=head, rank=rank,
                              is_cycle=is_cycle)

"""Ragged all-to-all record routing (the skew-proof exchange).

The padded routing (parallel/shard_count.py) reserves a fixed
``[n_shards, cap]`` block for every (source, destination) pair, so the
worst pair sets everyone's memory.  Here each destination has ONE budget,
``cap_total`` records, and senders send exactly their records: robust to
per-pair skew, bounded only by what one receiver takes.

Capacity discipline (the JAX package's, so the dropped counts agree):
every shard all-gathers the send-size matrix, and grants go greedily by
sender rank, ``granted[s] = clip(cap - excl_cumsum(sizes)[s], 0, sizes[s])``
-- once a receiver's budget is spent later senders get nothing -- so every
party agrees on the offsets with no extra round, nothing is written out of
bounds, and the dropped-record count is exact.

One semantics on both mesh forms: in one process the exchange is copies
between the shards' tensors, across processes ``all_to_all_single`` with
split sizes (parallel/mesh.py).  There is no native/emulated switch here:
that was a distinction between XLA backends.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from genome_assembly_tpu_torch.common import SENTINEL


def ragged_a2a(operands: Sequence[torch.Tensor], outputs: Sequence[torch.Tensor],
               input_offsets: Sequence[torch.Tensor], send_sizes: Sequence[torch.Tensor],
               output_offsets: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """``lax.ragged_all_to_all``'s semantics over a ``ShardMesh``.

    For every local shard (one entry of each list): rows
    ``operand[input_offsets[j] : input_offsets[j] + send_sizes[j]]`` go to
    shard ``j``, which writes them at ``output_offsets[j]`` of its output
    (``output_offsets`` is the SENDER's view of where its block lands).
    Returns the outputs, written in place.  The sizes and offsets are read
    back to the host (``n_shards`` numbers each)."""
    n = mesh.n_shards
    sizes_h = [s.tolist() for s in send_sizes]
    packed = []
    for x, start, sizes in zip(operands, input_offsets, sizes_h):
        start = start.tolist()
        packed.append(torch.cat([x[start[j]:start[j] + sizes[j]] for j in range(n)]))
    received = mesh.all_to_all_ragged(packed, sizes_h)
    # what each receiver needs from every sender: the block's size and offset
    meta = mesh.all_to_all([torch.stack([s, o], dim=1).reshape(n, 1, 2)
                            for s, o in zip(send_sizes, output_offsets)])
    for out, rows, m in zip(outputs, received, meta):
        at = 0
        for size, off in m.reshape(n, 2).tolist():
            out[off:off + size] = rows[at:at + size]
            at += size
    return list(outputs)


def route_records_ragged(
    owner_sorted: Sequence[torch.Tensor], payload: Sequence[torch.Tensor], *,
    n_shards: int, cap_total: int, mesh,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Route owner-sorted records to their owners with exact sizes.

    owner_sorted: one [n] int64 ascending owner a record, a local shard
    (``n_shards`` = invalid records, parked at the end).  payload: one
    [n, L] int64 tensor a local shard, rows in the same order.

    Returns (received [cap_total, L] SENTINEL-padded, dropped) a local
    shard: ``dropped`` counts this shard's records denied by receivers'
    budgets."""
    targets = torch.arange(n_shards, dtype=torch.int64)
    starts, sizes = [], []
    for owner in owner_sorted:
        t = targets.to(owner.device)
        start = torch.searchsorted(owner, t, side="left")
        starts.append(start)
        sizes.append(torch.searchsorted(owner, t, side="right") - start)
    gathered = mesh.all_gather(sizes)
    outputs, grants, offsets, dropped = [], [], [], []
    for s, size, mat in zip(mesh.local, sizes, gathered):
        mat = mat.reshape(n_shards, n_shards)  # [source, destination]
        excl = torch.cumsum(mat, dim=0) - mat
        granted = torch.minimum(torch.clamp(cap_total - excl, min=0), mat)
        out_off = torch.cumsum(granted, dim=0) - granted
        grants.append(granted[s])
        offsets.append(out_off[s])
        dropped.append((size - granted[s]).sum())
        outputs.append(torch.full((cap_total, payload[0].shape[1]), SENTINEL,
                                  dtype=torch.int64, device=size.device))
    received = ragged_a2a(payload, outputs, starts, grants, offsets, mesh)
    return received, dropped

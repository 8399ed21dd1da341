"""Two-level record routing over a mesh of slices.

A job that spans several hosts (or groups of cards) sees two networks: a
fast one within a slice and a slower one between slices.  A flat
all-to-all makes every (shard, shard) pair a message across slices.  Here
the exchange runs in two stages over a mesh of axes ``(slices, *ici)``
(parallel/mesh.py; ``ici`` one axis or several, taken together row-major):

  stage 1 (within a slice): every record goes to the shard of its own
                  slice whose coordinate within the slice is that of the
                  record's owner.  Shard ``(s, d)`` then holds exactly the
                  records of slice ``s`` owned by the ``d``-th shard of ANY
                  slice.
  stage 2 (across slices): an exchange along the slice axis only: shard
                  ``(s, d)`` sends its bucket for slice ``t`` to ``(t, d)``.
                  Every record crosses slices once, in one message a
                  (slice, slice) pair and shard column.

Ownership is the flat router's hash over all ``S * D`` shards (global shard
``g = ds * D + dd``), so the count equals the flat router's (routing
"padded" over the flat mesh of as many shards) row for row, every lane,
where the two layouts give every shard as many slots.

Before each stage-2 bucketize a shard compacts the real records it
received, in their order: a record's slot is its rank among its bucket's
records in input order and fill rows belong to no bucket, so the blocks and
the overflow counts are the JAX package's, and the padded stage-1 slots
(mostly fill at the default slack) are freed before stage 2 allocates its
own.  Each lane's staging is freed as it is sent (shard_count's
``_exchange_staged``).

The links join (``partitioned_unitig_links_join_two_level``) routes the
boundary records and the edges home in the same two stages; its links equal
``part_dbg.partitioned_unitig_links_join``'s over the flat mesh.  The port's
int64 state ids make the JAX package's wide (owner, local) forms these same
functions.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from genome_assembly_tpu_torch.common import MMER_SENTINEL, SENTINEL
from genome_assembly_tpu_torch.parallel import mesh as mesh_lib
from genome_assembly_tpu_torch.parallel import part_dbg, shard_count
from genome_assembly_tpu_torch.parallel.mesh import SHARD_AXIS, SLICE_AXIS

__all__ = ["SLICE_AXIS", "SHARD_AXIS", "sharded_count_two_level",
           "partitioned_unitig_links_join_two_level", "two_level_mesh", "two_level_mesh3"]


def _split(mesh):
    """(n_slices, n_ici, ici axes) of a ``(slices, *ici)`` mesh."""
    if mesh.axis_names[0] != SLICE_AXIS or len(mesh.shape) < 2:
        raise ValueError(f"a two-level mesh has axes (slices, *ici_axes), not {mesh.axis_names}")
    n_slices = mesh.shape[0]
    return n_slices, mesh.n_shards // n_slices, tuple(range(1, len(mesh.shape)))


def _stamp(walls: Optional[dict], name: str, t0: float, mesh) -> float:
    """With ``walls``: wait for the local shards' devices and record the
    seconds since ``t0`` under ``name``.  Returns the new start."""
    if walls is None:
        return t0
    for dev in {mesh.devices[s] for s in mesh.local}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    now = time.perf_counter()
    walls[name] = walls.get(name, 0.0) + now - t0
    return now


def _restage_by_slice(received: list, *, n_total: int, n_ici: int, n_slices: int, cap: int):
    """One shard's stage-1 records -> stage-2 staging (consumed).

    The real records are compacted in their order, then bucketed by their
    owner's slice into ``[n_slices, cap]`` blocks; the overflow carries the
    shard's stage-1 count plus this stage's."""
    idx = torch.nonzero(received[0] != MMER_SENTINEL).reshape(-1)
    lanes = [lane[idx] for lane in received[:len(shard_count.FILLS)]]
    overflow = received[len(shard_count.FILLS)]
    received.clear()
    del idx
    bucket = shard_count.owner_of(lanes[0], n_total) // n_ici
    bucket_s, order = torch.sort(bucket, stable=True)
    del bucket
    src, dst, ovf = shard_count._place(bucket_s, order, n_slices, cap)
    del bucket_s, order
    lanes = [lane[src] for lane in lanes]
    return [*shard_count._blocks(lanes, dst, n_slices, cap), overflow + ovf]


def sharded_count_two_level(codes, lengths, read_ids, *, k: int, m: int, parity: bool,
                            cutoff: int, mesh, slack: float = 4.0,
                            walls: Optional[dict] = None) -> shard_count.ShardedCount:
    """Distributed count and prune of one batch over a ``(slices, *ici)``
    mesh, minimizer-owned, routed in two stages.

    Arguments as ``shard_count.sharded_count``.  The result has one row a
    global shard in flat order and equals ``sharded_count(routing="padded")``
    over the flat mesh of as many shards (same owners, same slots where
    ``n_slices * cap2 == n_shards * cap``).  Stage capacities are the JAX
    package's: ``ceil(n_local / n_ici * slack)`` a block within a slice,
    ``ceil(n_local / n_slices * slack)`` across slices.  walls: a dict that
    gets the seconds of each stage (``scan_and_stage``, ``exchange_ici``,
    ``restage``, ``exchange_slices``, ``count``), the devices synchronised
    at each boundary."""
    n_slices, n_ici, ici_axes = _split(mesh)
    n_total = mesh.n_shards
    codes, lengths, read_ids = shard_count._batch_tensors(codes, lengths, read_ids)
    batch, max_len = codes.shape
    if batch % n_total:
        raise ValueError(f"batch of {batch} rows must divide the mesh size {n_total}")
    n_local = batch // n_total * (max_len - k + 1)
    cap1 = int(np.ceil(n_local / n_ici * slack))
    cap2 = int(np.ceil(n_local / n_slices * slack))
    t0 = time.perf_counter()
    staged = [
        shard_count._bucketize_records(c, l, r, s * n_local, k=k, m=m, parity=parity,
                                       n_shards=n_total, cap=cap1, n_ici=n_ici)
        for s, c, l, r in zip(mesh.local, mesh.shard_rows(codes), mesh.shard_rows(lengths),
                              mesh.shard_rows(read_ids))
    ]
    t0 = _stamp(walls, "scan_and_stage", t0, mesh)
    received = shard_count._exchange_staged(staged, n_shards=n_total, cap=cap1,
                                            routing="padded", mesh=mesh, axes=ici_axes)
    t0 = _stamp(walls, "exchange_ici", t0, mesh)
    staged = []
    for i in range(len(received)):
        staged.append(_restage_by_slice(received[i], n_total=n_total, n_ici=n_ici,
                                        n_slices=n_slices, cap=cap2))
        received[i] = None
    del received
    t0 = _stamp(walls, "restage", t0, mesh)
    received = shard_count._exchange_staged(staged, n_shards=n_total, cap=cap2,
                                            routing="padded", mesh=mesh, axes=(0,))
    t0 = _stamp(walls, "exchange_slices", t0, mesh)
    out = shard_count._count_received([received], cutoff=cutoff, n_local=len(mesh.local))
    _stamp(walls, "count", t0, mesh)
    return out


def _two_stage(lanes_of, bucket_of, fills, *, mesh, n_ici, n_slices, ici_axes, cap1, cap2):
    """Route records in two stages, packed by ``part_dbg._pack_by_owner``.

    lanes_of: one (active mask, lanes) pair a local shard; bucket_of(lanes)
    gives each record's global owner shard.  Returns (one ``[rows, L]``
    tensor a local shard of the records received, FILLS where none; one
    overflow count a local shard)."""
    blocks, ovf1 = [], []
    for active, lanes in lanes_of:
        b, ovf = part_dbg._pack_by_owner(bucket_of(lanes) % n_ici, active, lanes, fills,
                                         n_ici, cap1)
        blocks.append(b)
        ovf1.append(ovf)
    del lanes_of
    got = mesh.all_to_all(blocks, ici_axes)
    del blocks
    blocks, ovf2 = [], []
    for i in range(len(got)):
        r = got[i].reshape(-1, len(fills))
        got[i] = None
        lanes = tuple(r[:, j] for j in range(len(fills)))
        b, ovf = part_dbg._pack_by_owner(bucket_of(lanes) // n_ici, lanes[0] != fills[0],
                                         lanes, fills, n_slices, cap2)
        blocks.append(b)
        ovf2.append(ovf)
    got = mesh.all_to_all(blocks, (0,))
    return ([g.reshape(-1, len(fills)) for g in got], [a + b for a, b in zip(ovf1, ovf2)])


def partitioned_unitig_links_join_two_level(kmer: Sequence[torch.Tensor],
                                            valid: Sequence[torch.Tensor], *, k: int, mesh,
                                            slack: float = 4.0):
    """next_state via the routed (k-1)-mer sort-join over a ``(slices,
    *ici)`` mesh: the boundary records, and then the edges on their way
    home, cross slices once each.

    Arguments and result as ``part_dbg.partitioned_unitig_links_join``
    (whose links it equals over the flat mesh of as many shards); overflow
    is the sum of the four stages' counts a shard, capacities the JAX
    package's."""
    if k % 2 == 0:
        raise ValueError("fast-mode dBG requires odd k")
    n_slices, n_ici, ici_axes = _split(mesh)
    n_total = mesh.n_shards
    rows = part_dbg._rows(kmer)
    if 2 * rows * n_total >= 1 << 62:
        raise ValueError("too many states for the (side, state) record payload")
    n_local = 4 * rows  # boundary records a shard
    cap1 = max(1, int(np.ceil(n_local / n_ici * slack)))
    cap2 = max(1, int(np.ceil(n_local / n_slices * slack)))
    cap_e1 = max(1, int(np.ceil(2 * rows / n_ici * slack)))
    cap_e2 = max(1, int(np.ceil(2 * rows / n_slices * slack)))

    records = []
    for s, kmer_l, valid_l in zip(mesh.local, kmer, valid):
        g0 = 2 * (s * rows + torch.arange(rows, device=kmer_l.device))
        key, payload, active = part_dbg._boundary_records(kmer_l, valid_l, k=k,
                                                          gid=torch.cat([g0, g0 + 1]))
        records.append((active, (key, payload)))
    received, ovf_rec = _two_stage(
        records, lambda lanes: part_dbg._key_owner(lanes[0], n_total), (SENTINEL, -1),
        mesh=mesh, n_ici=n_ici, n_slices=n_slices, ici_axes=ici_axes, cap1=cap1, cap2=cap2)
    del records

    def home(lanes):
        return lanes[0].clamp(0, 2 * rows * n_total - 1) // (2 * rows)

    edges = []
    for i in range(len(received)):
        r = received[i]
        received[i] = None
        edge, state_s, target = part_dbg._pair_edges(r[:, 0], r[:, 1])
        edges.append((edge, (state_s, target)))
    del received
    back, ovf_edge = _two_stage(edges, home, (-1, -1), mesh=mesh, n_ici=n_ici,
                                n_slices=n_slices, ici_axes=ici_axes, cap1=cap_e1, cap2=cap_e2)
    links = []
    for s, b, kmer_l in zip(mesh.local, back, kmer):
        got = b[:, 0] >= 0
        next_l = torch.full((2 * rows,), -1, dtype=torch.int64, device=kmer_l.device)
        next_l[b[got, 0] - 2 * s * rows] = b[got, 1]
        links.append(next_l)
    return links, [a + b for a, b in zip(ovf_rec, ovf_edge)]


def _visible(devices):
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("a two-level mesh takes the visible CUDA devices and this "
                               "machine has none; pass devices=['cpu'] for a CPU mesh")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [devices] if isinstance(devices, (str, torch.device)) else list(devices)


def two_level_mesh(n_slices: int, devices=None, n_shards: Optional[int] = None):
    """A one-process ``(slices, shards)`` mesh over the visible cards (or
    ``devices``), ``n_slices`` on the slice axis.  n_shards: default one
    shard a device; more shards share devices as in ``mesh.make_mesh``."""
    devices = _visible(devices)
    n = len(devices) if n_shards is None else int(n_shards)
    if n % n_slices:
        raise ValueError(f"{n} shards do not split into {n_slices} slices")
    return mesh_lib.make_mesh(devices=devices, shape=(n_slices, n // n_slices))


def two_level_mesh3(n_slices: int, x: int, y: int, devices=None):
    """A one-process ``(slices, x, y)`` mesh: the slice axis and a 2-D grid
    within each slice, over the visible cards (or ``devices``; with fewer
    devices than shards, shards share them)."""
    return mesh_lib.make_mesh(devices=_visible(devices), shape=(n_slices, x, y))

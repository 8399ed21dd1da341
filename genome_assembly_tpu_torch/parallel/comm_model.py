"""Exact wire traffic of the routers, and an analytic scaling model on it.

Every router of this package is a deterministic function of its input: the
count's owner hash (``shard_count.owner_of`` / ``key_owner_of``), the links
join's (k-1)-mer hash owner (``part_dbg._key_owner``) and the jump's row
ranges.  So the whole shard-to-shard exchange matrix of a phase can be
computed without running the exchange, on any device; from it, each phase's
bytes on the wire, its skew, and a predicted scaling efficiency.  The
counterpart of the JAX package's ``parallel/comm_model.py``: the same
functions in the same order, matrices equal to JAX's on the same input.

The matrices are computed with the routers' own functions, in torch on the
tensors' device (one ``bincount`` or ``unique`` a phase, not a host loop
over shards), and returned as int64 numpy ``[n_shards, n_shards]``.

What differs from JAX, by design:

  * bytes per record are this package's wire widths (``*_BYTES`` below,
    each named at the router that sends it), not JAX's uint32 lanes;
  * every rate is the port's own, measured on an H100 (``H100_*``); the
    bandwidths between cards and between hosts are required fields of
    ``Hardware``: one card cannot measure them;
  * ``parked_links_model`` plans exactly what this package's
    ``ops/dbg.build_unitig_links_parked`` performs, and prices the host
    path a card has (pageable copies, kernel launches);
  * ids are int64 everywhere, so JAX's "wide" (shard, local) pricing is
    the only one: ``extension_phase_model`` has no ``wide`` switch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from genome_assembly_tpu_torch.ops import encode, minimizer

# ---------------------------------------------------------------------------
# wire widths: bytes a record of each router moves
# ---------------------------------------------------------------------------

# count: int32 m-mer + int64 key, read id and stream (parallel/shard_count.py:164)
COUNT_RECORD_BYTES = 4 + 8 + 8 + 8
# links join: int64 (k-1)-mer key + int64 side|state payload (parallel/part_dbg.py:200)
LINK_RECORD_BYTES = 8 + 8
# jump, predecessor table: int64 (next, source) pairs (parallel/part_dbg.py:254)
PRED_RECORD_BYTES = 8 + 8
# jump, a round's request: one int64 parent id (parallel/part_dbg.py:137)
JUMP_REQUEST_BYTES = 8
# jump, a round's answer: int64 parent, rank and min id (parallel/part_dbg.py:146)
JUMP_RESPONSE_BYTES = 8 + 8 + 8
# jump, the final cycle probe's answer: one int64 predecessor (parallel/part_dbg.py:285)
FINAL_RESPONSE_BYTES = 8
# parked links: a node's int64 key + bool valid uploaded a chunk at a time
# (ops/dbg.py:330), an edge's int64 (src, dst) read back (ops/dbg.py:353)
PARKED_UPLOAD_BYTES_PER_NODE = 8 + 1
PARKED_EDGE_BYTES = 8 + 8

# ---------------------------------------------------------------------------
# single-card rates, measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit (nvidia-smi), torch 2.11.0+cu128, by chip_smoke.py's ``comm_model``
# phase: every figure below is the ``comm_model_rates`` line of one run, which
# names each rate's source; PERF.md section 6 names that run and gives each
# rate's spread over the runs
# ---------------------------------------------------------------------------

# count records (valid windows) scanned, counted and pruned a second: K1 +
# count_keys + kept_keys_sorted of the ecoli reads as one [2300000, 128]
# batch, CUDA events, the median of 5 warm runs
H100_COUNT_RECORDS_PER_S = 4408701624.490567
# link records joined a second (full_e2e: 4 x kept nodes / links seconds)
H100_LINK_RECORDS_PER_S = 2004088154.8815947
# states of one pointer-jump round a second (one row gather of the ecoli links' table)
H100_JUMP_STATES_PER_S = 6341487638.078224
# boundary records made and extracted a second, one chunk of the parked link build
H100_EXTRACT_ROWS_PER_S = 1889748239.7303765
# link records sort-joined a second, one partition of the parked link build
H100_JOIN_ROWS_PER_S = 3595991145.123124
# edges scattered into the link array a second (the link build without parked links)
H100_SCATTER_ROWS_PER_S = 25857597591.572334
# host seconds of one kernel launch (an empty launch loop, timed on the host)
H100_LAUNCH_S = 9.381934000003866e-06
# host <-> card copies: pageable numpy (what the parked link build moves) and pinned
H100_UPLOAD_BYTES_PER_S = 6208846772.250689
H100_READBACK_BYTES_PER_S = 2286423124.4116206
H100_PINNED_UPLOAD_BYTES_PER_S = 53322281479.05556
H100_PINNED_READBACK_BYTES_PER_S = 55106199834.70483


class Hardware(NamedTuple):
    """A card and its fabric for the scaling model.

    ``link_bytes_per_s``: achievable bytes a second one card sends (and
    receives) to the other cards of its host, e.g. NVLink; ``network_bytes_per_s``:
    the same across hosts (the second level of ``two_level``).  Both are
    required: one card cannot measure them.  The single-card rates default
    to the H100 measurements above.
    """

    link_bytes_per_s: float
    network_bytes_per_s: float
    count_records_per_s: float = H100_COUNT_RECORDS_PER_S
    link_records_per_s: float = H100_LINK_RECORDS_PER_S
    jump_states_per_s: float = H100_JUMP_STATES_PER_S


def _as_tensor(x, device=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t if device is None else t.to(device)


def _matrix(flat: torch.Tensor, n_shards: int) -> np.ndarray:
    """[n, n] int64 numpy of a flat ``src * n + dst`` record list."""
    return torch.bincount(flat, minlength=n_shards * n_shards).reshape(
        n_shards, n_shards).cpu().numpy().astype(np.int64)


def count_exchange_matrix(codes, lengths, *, k: int, m: int, n_shards: int,
                          parity: bool = False, route_by: str = "mmer",
                          device=None) -> np.ndarray:
    """[n_shards, n_shards] records routed src -> dst by the count phase.

    Exactly the traffic ``shard_count.sharded_count`` generates: rows are
    block-sharded over shards, each valid window record goes to
    ``owner_of(mmer)`` (route_by="mmer") or ``key_owner_of(kmer)``
    (route_by="key").  Diagonal entries stay on the shard.  codes [B, L]
    uint8 and lengths [B] (tensors or numpy) are scanned on ``device``
    (default: where they lie; on a card the scan is K1)."""
    from genome_assembly_tpu_torch.parallel.shard_count import key_owner_of, owner_of

    codes = _as_tensor(codes, device)
    lengths = _as_tensor(lengths, codes.device).to(torch.int32)
    scan = minimizer.parity_scan if parity else minimizer.fast_scan
    recs = scan(codes, lengths, k=k, m=m)
    rows = recs.kmer.shape[0]
    if rows % n_shards:
        raise ValueError(f"rows={rows} must divide n_shards={n_shards}")
    if route_by == "key":
        owner = key_owner_of(recs.kmer, n_shards)
    else:
        owner = owner_of(recs.mmer, n_shards)
    src = torch.arange(rows, device=codes.device)[:, None] // (rows // n_shards)
    return _matrix((src * n_shards + owner)[recs.valid], n_shards)


def links_exchange_matrix(kmer, valid, *, k: int, n_shards: int) -> np.ndarray:
    """[n_shards, n_shards] boundary records routed src -> dst by the
    distributed sort-join (``part_dbg.partitioned_unitig_links_join``).

    Each shard emits 4 records per node (OUT/IN x both strands) to the
    (k-1)-mer key's hash owner (``part_dbg._key_owner``).  kmer: the port's
    one int64 key lane ([N], sorted kept keys; tensors, computed where they
    lie, or numpy), valid [N].  The edges-home return trip (at most one
    record a state) is not in the matrix."""
    from genome_assembly_tpu_torch.parallel.part_dbg import _key_owner

    kmer = _as_tensor(kmer)
    valid = _as_tensor(valid, kmer.device).bool()
    n = kmer.shape[0]
    if n % n_shards:
        raise ValueError(f"n={n} must divide n_shards={n_shards}")
    src = torch.arange(n, device=kmer.device) // (n // n_shards)
    flat = []
    for oriented in (kmer, encode.reverse_complement_packed(kmer, k)):
        for key in (oriented & ((1 << (2 * k - 2)) - 1), oriented >> 2):
            flat.append((src * n_shards + _key_owner(key, n_shards))[valid])
    return _matrix(torch.cat(flat), n_shards)


def jump_request_matrices(next_state, *, n_shards: int):
    """Exact per-phase request matrices of ``part_dbg.partitioned_pointer_jump``.

    The predecessor-table build routes each (dest, src) edge to dest's
    range owner without deduplication; every doubling round and the final
    cycle probe route one request per DISTINCT remote parent per shard
    (``_routed_gather`` combines requests).  Local requests are never
    routed, so every diagonal is zero.  next_state: [2N] global successors
    (-1: none), a tensor (computed where it lies) or numpy.  Returns (pred_matrix, [round matrices], final_matrix);
    the rounds are ``part_dbg.jump_rounds(2N)``, as the jump runs them."""
    from genome_assembly_tpu_torch.parallel.part_dbg import jump_rounds

    ns = _as_tensor(next_state).to(torch.int64)
    n2 = ns.shape[0]
    if n2 % n_shards:
        raise ValueError(f"n2={n2} must divide n_shards={n_shards}")
    rows2 = n2 // n_shards
    ids = torch.arange(n2, device=ns.device)
    shard_of = ids // rows2

    def req_matrix(dests, dedup):
        keep = dests >= 0
        pair = shard_of[keep] * n2 + dests[keep]
        if dedup:
            pair = torch.unique(pair)
        src, owner = pair // n2, (pair % n2) // rows2
        return _matrix((src * n_shards + owner)[owner != src], n_shards)

    pred_mat = req_matrix(ns, dedup=False)
    pred = torch.full((n2,), -1, dtype=torch.int64, device=ns.device)
    pred[ns[ns >= 0]] = ids[ns >= 0]
    parent = torch.where(pred >= 0, pred, ids)
    round_mats = []
    for _ in range(jump_rounds(n2)):
        round_mats.append(req_matrix(parent, dedup=True))
        parent = parent[parent]
    return pred_mat, round_mats, req_matrix(parent, dedup=True)


def gather_phase_model(matrix: np.ndarray, *, resp_bytes: int, states_per_shard: int,
                       states_per_s: float, hw: Hardware,
                       req_bytes: int = JUMP_REQUEST_BYTES) -> dict:
    """One routed-gather phase: requests go src -> dst (``req_bytes`` each),
    answers come back dst -> src (``resp_bytes`` each).

    Both directions ride the wire: per card, send bytes = its outgoing
    requests + the answers it owes, receive bytes the mirror.  Compute is
    the per-shard state update, at least ``states_per_shard`` whatever the
    traffic."""
    n = matrix.shape[0]
    out_req = matrix.sum(axis=1).astype(np.float64)
    in_req = matrix.sum(axis=0).astype(np.float64)
    send = req_bytes * out_req + resp_bytes * in_req
    recv = req_bytes * in_req + resp_bytes * out_req
    wire = float(np.maximum(send, recv).max()) if n > 1 else 0.0
    t_comm = wire / hw.link_bytes_per_s
    t_comp = states_per_shard / states_per_s
    return {
        "requests_total": int(matrix.sum()),
        "t_compute_s": t_comp,
        "t_comm_s": t_comm,
        "t_serial_s": t_comp + t_comm,
        "t_overlap_s": max(t_comp, t_comm),
    }


def extension_phase_model(links_matrix: np.ndarray, next_state, *, n_shards: int,
                          hw: Hardware, link_record_bytes: int = LINK_RECORD_BYTES,
                          pred_record_bytes: int = PRED_RECORD_BYTES,
                          request_bytes: int = JUMP_REQUEST_BYTES,
                          response_bytes: int = JUMP_RESPONSE_BYTES,
                          final_response_bytes: int = FINAL_RESPONSE_BYTES) -> dict:
    """Distributed-extension efficiency: the routed link join plus every
    pointer-jump phase's routed gather, from the routers' exact traffic
    (``links_exchange_matrix`` + ``jump_request_matrices``), each record at
    its wire width (defaults: this package's routers)."""
    n2 = len(next_state)
    rows2 = n2 // n_shards
    link_phase = phase_model(links_matrix, bytes_per_record=link_record_bytes,
                             records_per_s=hw.link_records_per_s, hw=hw)
    pred_mat, round_mats, final_mat = jump_request_matrices(next_state, n_shards=n_shards)
    serial = link_phase["t_compute_s"] + link_phase["t_comm_s"]
    overlap = max(link_phase["t_compute_s"], link_phase["t_comm_s"])
    peak_pair = int(pred_mat.max())
    req_total = 0
    # pred build: one-way (dest, src) records, no answer; rounds: a parent
    # request, (parent, rank, min) answers; final probe: a request, a pred
    for mat, rq, rp in ([(pred_mat, pred_record_bytes, 0)]
                        + [(mm, request_bytes, response_bytes) for mm in round_mats]
                        + [(final_mat, request_bytes, final_response_bytes)]):
        g = gather_phase_model(mat, req_bytes=rq, resp_bytes=rp, states_per_shard=rows2,
                               states_per_s=hw.jump_states_per_s, hw=hw)
        serial += g["t_serial_s"]
        overlap += g["t_overlap_s"]
        peak_pair = max(peak_pair, int(mat.max()))
        req_total += g["requests_total"]
    steps = len(round_mats)
    t_1card = (int(links_matrix.sum()) / hw.link_records_per_s
               + (steps + 2) * n2 / hw.jump_states_per_s)
    return {
        "shards": n_shards,
        "jump_rounds": steps,
        "requests_total": req_total,
        "peak_pair_requests": peak_pair,
        "t_serial_s": serial,
        "t_overlap_s": overlap,
        "eff_serial": t_1card / (n_shards * serial) if serial else 1.0,
        "eff_overlap": t_1card / (n_shards * overlap) if overlap else 1.0,
    }


def two_level_split(matrix: np.ndarray, *, n_slices: int) -> dict:
    """Split a flat exchange matrix into within-slice and across-slice
    volumes under the two-level router (parallel/two_level.py).

    Shards are slice-major (global shard g = slice * n_ici + intra), as a
    two-level mesh lays them out.  Stage 1 moves every record whose owner's
    intra-slice index differs from its source's once within the slice;
    stage 2 moves every record whose owner sits on another slice once
    across slices, one aggregated message per (slice, slice) pair a column.
    A flat all-to-all sends the same cross-slice bytes as one message per
    (shard, shard) pair."""
    n = matrix.shape[0]
    if n % n_slices:
        raise ValueError(f"{n} devices do not split into {n_slices} slices")
    n_ici = n // n_slices
    src_slice = np.arange(n) // n_ici
    cross = src_slice[:, None] != src_slice[None, :]
    src_intra = np.arange(n) % n_ici
    cross_intra = src_intra[:, None] != src_intra[None, :]
    ici_records = int(matrix[cross_intra].sum())
    dcn_records = int(matrix[cross].sum())
    slice_cross = matrix.reshape(n_slices, n_ici, n_slices, n_ici).sum(axis=(1, 3))
    np.fill_diagonal(slice_cross, 0)
    per_device_dcn = slice_cross.sum(axis=1) / n_ici  # balanced by the hash
    return {
        "n_slices": n_slices,
        "n_ici": n_ici,
        "ici_records": ici_records,
        "dcn_records": dcn_records,
        "dcn_fraction": dcn_records / max(int(matrix.sum()), 1),
        "dcn_records_max_device": float(per_device_dcn.max()),
        "dcn_messages_two_level": n_slices * (n_slices - 1) * n_ici,
        "dcn_messages_flat": int(cross.sum()),  # one per device pair
    }


def two_level_phase_model(matrix: np.ndarray, *, n_slices: int, bytes_per_record: int,
                          records_per_s: float, hw: Hardware, n_batches: int = 1) -> dict:
    """Efficiency under the two-level router, from each shard's exact stage
    traffic (shards slice-major):

      stage 1 (within each slice, ``hw.link_bytes_per_s``): shard d sends the
        records it holds for owner o to shard (slice(d), intra(o));
      stage 2 (across slices, ``hw.network_bytes_per_s``): staging shard
        (s, j) forwards the records owned by (s', j), s' != s;
      count: the owner processes everything it received.

    Walls are per-shard maxima over send/receive bytes at the stage's
    rate.  ``n_batches`` > 1 prices a software pipeline with the two stages'
    wire times summed: T = c + (B - 1) max(c, w) + w."""
    n = matrix.shape[0]
    if n % n_slices:
        raise ValueError(f"{n} devices do not split into {n_slices} slices")
    n_ici = n // n_slices
    dev_slice = np.arange(n) // n_ici
    dev_intra = np.arange(n) % n_ici

    same_intra = dev_intra[:, None] == dev_intra[None, :]
    send1 = (matrix * ~same_intra).sum(axis=1)
    recv1 = np.zeros(n)
    for s in range(n_slices):
        rows = matrix[dev_slice == s]
        src_intra = dev_intra[dev_slice == s]
        for j in range(n_ici):
            cols = rows[:, dev_intra == j]
            recv1[s * n_ici + j] = cols.sum() - cols[src_intra == j].sum()

    send2 = np.zeros(n)
    recv2 = np.zeros(n)
    for s in range(n_slices):
        rows = matrix[dev_slice == s]
        for j in range(n_ici):
            col_owners = dev_intra == j
            for s2 in range(n_slices):
                vol = rows[:, col_owners & (dev_slice == s2)].sum()
                if s2 != s:
                    send2[s * n_ici + j] += vol
                    recv2[s2 * n_ici + j] += vol

    recv_final = matrix.sum(axis=0)
    total = int(matrix.sum())
    t_comp = float(recv_final.max()) / records_per_s
    t_ici = float(np.maximum(send1, recv1).max()) * bytes_per_record / hw.link_bytes_per_s
    t_dcn = float(np.maximum(send2, recv2).max()) * bytes_per_record / hw.network_bytes_per_s
    t_wire = t_ici + t_dcn
    t_comp_1card = total / records_per_s
    B = max(n_batches, 1)
    c, w = t_comp / B, t_wire / B
    t_pipe = c + (B - 1) * max(c, w) + w
    return {
        "shards": n,
        "n_slices": n_slices,
        "t_compute_s": t_comp,
        "t_ici_s": t_ici,
        "t_dcn_s": t_dcn,
        "eff_serial": t_comp_1card / (n * (t_comp + t_wire)),
        "eff_overlap": t_comp_1card / (n * max(t_comp, t_wire)),
        "eff_pipelined": t_comp_1card / (n * t_pipe),
        "n_batches": B,
    }


def pipeline_model(matrix: np.ndarray, *, n_batches: int, bytes_per_record: int,
                   records_per_s: float, hw: Hardware) -> dict:
    """Efficiency of a multi-batch count whose exchange of batch i - 1 runs
    while batch i is scanned:

        T = t_scan_b + (B - 1) max(t_scan_b, t_comm_b) + t_comm_b

    At B = 1 it is phase_model's eff_serial; as B grows it tends to its
    eff_overlap.  The port's ``sharded_count_batches`` runs the batches
    one after another (no such overlap), so this is the schedule's
    prediction, not the port's.  matrix: the whole stream's exchange
    matrix; a batch carries matrix / B."""
    n = matrix.shape[0]
    base = phase_model(matrix, bytes_per_record=bytes_per_record,
                       records_per_s=records_per_s, hw=hw)
    t_comp_b = base["t_compute_s"] / n_batches
    t_comm_b = base["t_comm_s"] / n_batches
    t_total = t_comp_b + max(0, n_batches - 1) * max(t_comp_b, t_comm_b) + t_comm_b
    t_comp_1card = int(matrix.sum()) / records_per_s
    return {
        **base,
        "n_batches": n_batches,
        "t_pipelined_s": t_total,
        "eff_pipelined": t_comp_1card / (n * t_total) if t_total else 1.0,
    }


def phase_model(matrix: np.ndarray, *, bytes_per_record: int, records_per_s: float,
                hw: Hardware) -> dict:
    """Per-phase wire and compute seconds and the predicted scaling
    efficiency.  matrix[i, j] = records shard i sends shard j (diagonal:
    stays local).  The efficiency is a band against a perfect n-card split
    of the one-card compute time: eff_overlap (compute and wire fully
    overlapped) and eff_serial (none)."""
    n = matrix.shape[0]
    total = int(matrix.sum())
    offchip = matrix.sum(axis=1) - np.diag(matrix)
    inbound = matrix.sum(axis=0) - np.diag(matrix)
    wire = np.maximum(offchip, inbound)
    max_wire_bytes = float(wire.max()) * bytes_per_record if n > 1 else 0.0
    recv = matrix.sum(axis=0)
    t_comp_1card = total / records_per_s
    t_comp = float(recv.max()) / records_per_s  # the most loaded shard
    t_comm = max_wire_bytes / hw.link_bytes_per_s
    t_overlap = max(t_comp, t_comm)
    t_serial = t_comp + t_comm
    return {
        "shards": n,
        "records_total": total,
        "offchip_records_max": int(wire.max()) if n > 1 else 0,
        "offchip_fraction": float(offchip.sum()) / total if total else 0.0,
        "recv_skew": float(recv.max() / max(recv.mean(), 1e-9)),
        "t_compute_s": t_comp,
        "t_comm_s": t_comm,
        "eff_overlap": t_comp_1card / (n * t_overlap) if t_overlap else 1.0,
        "eff_serial": t_comp_1card / (n * t_serial) if t_serial else 1.0,
    }


class HostLink(NamedTuple):
    """The host <-> card path of one card's parked link build.

    The build is bound by that path and by its sorts, not by a fabric: a
    launch's host cost per chunk sweep and per partition (``dispatch_s``),
    the keys uploaded a chunk at a time, the boundary records made and
    extracted a chunk at a time, a sort-join a partition, and each
    partition's edges read back (parked links) or scattered.  Defaults:
    the H100 measurements above (pageable copies, as the link build makes
    them)."""

    dispatch_s: float = H100_LAUNCH_S
    upload_bytes_per_s: float = H100_UPLOAD_BYTES_PER_S
    readback_bytes_per_s: float = H100_READBACK_BYTES_PER_S
    extract_rows_per_s: float = H100_EXTRACT_ROWS_PER_S
    join_rows_per_s: float = H100_JOIN_ROWS_PER_S
    scatter_rows_per_s: float = H100_SCATTER_ROWS_PER_S


def parked_links_model(n_nodes: int, *, partitions: int, chunk_nodes: int = 1 << 23,
                       park_keys: bool = True, park_links: bool = True,
                       link: HostLink = HostLink()) -> dict:
    """Wall budget of ``ops/dbg.build_unitig_links_parked``.

    The same ``outofcore.range_group_plan`` call as that function (12 B a
    record, ``dbg.LINK_GROUP_BUDGET_BYTES`` read now, sigma_scale 2.9), so
    the group size G, the passes and the chunks a sweep are exactly its
    own; each is priced from the ``HostLink`` rates:

      sweep      = n_chunks x (dispatch + key upload + records and extraction)
      partition  = dispatch + sort-join + edge read-back (or scatter)
      total      = ceil(P / G) x sweep + P x partition

    A partition re-extracted alone after its staging cap overflowed (the
    link build's self-heal) is not in the plan, so not in the total."""
    from genome_assembly_tpu_torch.ops import dbg, outofcore

    n_chunks = -(-n_nodes // chunk_nodes)
    rec_per_chunk = 4 * chunk_nodes
    cap_bp, G = outofcore.range_group_plan(
        n_chunks, rec_per_chunk, partitions=partitions, bytes_per_record=12,
        budget_bytes=dbg.LINK_GROUP_BUDGET_BYTES, sigma_scale=2.9)
    n_passes = -(-partitions // G)
    upload_bytes = chunk_nodes * PARKED_UPLOAD_BYTES_PER_NODE if park_keys else 0
    t_chunk_dispatch = link.dispatch_s
    t_chunk_upload = upload_bytes / link.upload_bytes_per_s
    t_chunk_extract = rec_per_chunk / link.extract_rows_per_s
    t_sweep = n_chunks * (t_chunk_dispatch + t_chunk_upload + t_chunk_extract)

    recs_per_part = 4.0 * n_nodes / partitions
    edges_per_part = 2.0 * n_nodes / partitions  # at most one out-edge a state
    t_part_join = recs_per_part / link.join_rows_per_s
    t_part_io = (edges_per_part * PARKED_EDGE_BYTES / link.readback_bytes_per_s
                 if park_links else edges_per_part / link.scatter_rows_per_s)
    t_part = link.dispatch_s + t_part_join + t_part_io

    t_dispatch_total = n_passes * n_chunks * t_chunk_dispatch + partitions * link.dispatch_s
    total = n_passes * t_sweep + partitions * t_part
    return {
        "n_nodes": n_nodes,
        "partitions": partitions,
        "chunk_nodes": chunk_nodes,
        "n_chunks": n_chunks,
        "group_size": int(G),
        "cap_bp": int(cap_bp),
        "n_passes": n_passes,
        "t_pass_sweep_s": t_sweep,
        "t_partition_s": t_part,
        "t_dispatch_total_s": t_dispatch_total,
        "t_total_s": total,
        "dispatch_fraction": t_dispatch_total / total,
    }

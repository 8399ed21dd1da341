"""End-to-end assembly pipelines.

Fast mode (``FastAssembler``): ingest (host) -> canonical scan -> count ->
prune -> links -> pointer jump -> materialize (host).

Parity mode (``ParityAssembler``): ingest with the reference's ``fgets``
quirks (host) -> signature scan -> count with read-id and stream payloads
(device) -> host table -> order-faithful replay of prune, expand and
extension (host: the Python spec or the C++ engine) -> the reference's
exact output.

Past ``outofcore_bytes`` of window records both modes count out of core
(ops/outofcore.py): each pass re-scans every batch and counts a group of
hash partitions; fast mode then builds its links out of core past
``link_budget_bytes`` and jumps with the low-memory bulk form past
``bulk_jump_states``, and materializes on the device.  The limits and the
switch formulas are the JAX package's, so both packages take the same
branch for one config.

Given a ``mesh`` (parallel/mesh.py: shards in one process, or one shard a
process over ``torch.distributed``) both modes count over the mesh
(parallel/shard_count.py): fast mode with one key-routed batch, then the
routed link join and the sharded (or, past 2**31 states, the routed) jump
over the mesh's row blocks of the kept keys, and the host materializer;
parity mode with minimizer-routed batches feeding the same replay.  As in
the JAX package, the assemblers route flat; the two-level router
(parallel/two_level.py) is ``shard_count.sharded_count(routing="two_level")``.

Every entry point takes ``device`` and defaults to ``"cuda"``: asked for a
card on a machine without one it raises, it does not carry on on the CPU.
A mesh names its own devices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from genome_assembly_tpu_torch.common import SENTINEL
from genome_assembly_tpu_torch.config import PipelineConfig
from genome_assembly_tpu_torch.io import reads as reads_io
from genome_assembly_tpu_torch.io import stream as stream_io
from genome_assembly_tpu_torch.native import replay_native
from genome_assembly_tpu_torch.ops import count as count_ops
from genome_assembly_tpu_torch.ops import dbg
from genome_assembly_tpu_torch.ops import minimizer
from genome_assembly_tpu_torch.ops import outofcore
from genome_assembly_tpu_torch.parallel import part_dbg, shard_count, shard_dbg
from genome_assembly_tpu_torch.parity import nonacgt
from genome_assembly_tpu_torch.parity import replay as replay_mod
from genome_assembly_tpu_torch.parity import table as table_ops
from genome_assembly_tpu_torch.utils import profiling
from genome_assembly_tpu_torch.utils.plots import parse_verbose_table


@dataclasses.dataclass
class PhaseStats:
    """What one run observed of itself.

    wall_s: the host-clock seconds of each phase of the run; device phases
    are closed with a synchronize when they ran on a card.
    spans_s: the host seconds of each timed step inside a phase, keyed
    ``<phase>.<step>`` (``utils/profiling.span``).  A step adds no
    synchronize: its device work is counted in the step that first waits
    for it, and a phase's steps need not cover all of it.
    counts: the run's counters (``utils/profiling.count``): ``h2d_bytes``,
    the bytes handed to the device (read batches, kept keys back on the
    card), and ``d2h_bytes``, the bytes of every read-back larger than a
    scalar.
    """

    n_reads: int = 0
    n_windows: int = 0
    entries_pre_prune: int = 0
    entries_post_prune: int = 0
    entries_post_extension: int = 0
    wall_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    spans_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)


def _check_device(device, who: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} was asked for a CUDA device and this machine "
            "has none; pass device='cpu' to run on the CPU"
        )
    return device


def _extension_graph(kmer, valid, *, k: int, clock: profiling.PhaseClock,
                     link_budget: Optional[int] = None,
                     bulk_jump_states: Optional[int] = None):
    """Links + jump, as the clock's phases ``links`` and ``jump`` (the
    jump's is left running).

    In core (no limits given) the join and the fused jump.  Past device
    memory, with the JAX package's switches: when the 4N link records
    would exceed ~3x ``link_budget`` (at the JAX package's 12 bytes a
    record) the links are built out of core, and above
    ``bulk_jump_states`` states the jump takes its low-memory bulk form."""
    clock.start("links")
    n_nodes = int(kmer.shape[0])
    rec_bytes = 4 * n_nodes * 12
    if link_budget is None or rec_bytes <= 3 * link_budget:
        links = dbg.build_unitig_links_join(kmer, valid, k=k)
    else:
        # build_unitig_links_ooc pads the keys to a chunk multiple: cap the chunk near
        # the input size
        chunk_nodes = min(1 << 24, 1 << int(np.ceil(np.log2(max(n_nodes, 2)))))
        links = dbg.build_unitig_links_ooc(
            kmer, valid, k=k, partitions=int(np.ceil(rec_bytes / link_budget)),
            chunk_nodes=chunk_nodes)
    clock.start("jump")
    if bulk_jump_states is not None and 2 * n_nodes > bulk_jump_states:
        graph = dbg.pointer_jump_bulk(links)
    else:
        graph = dbg.pointer_jump(links)
    return graph


def _batch_source(batches, device, fn):
    """b -> fn(b, codes, lengths, read_ids) of host batch b, copied to the
    device anew on every call (each out-of-core pass re-scans) by the
    feeder's staging function."""
    stage, receive = stream_io.batch_stager(device)

    def records(b):
        with profiling.span("stage"):
            staged = stage(batches[b])
            codes, lengths, rids = staged if receive is None else receive(staged)
        with profiling.span("scan"):
            return fn(b, codes, lengths, rids)
    return records


class CountPipeline:
    """Device-side scan and count shared by both modes.

    In parity mode the scan replicates the reference's per-read scan
    exactly, and the count keys groups by (signature, k-mer): the table
    is a multiset keyed by the pair, so a k-mer binned under two
    signatures is two entries, as in the reference.
    """

    def __init__(self, config: PipelineConfig, device="cuda"):
        self.config = config
        self.device = torch.device(device)

    def scan(self, codes: torch.Tensor, lengths: torch.Tensor) -> minimizer.WindowRecords:
        cfg = self.config
        if cfg.parity:
            return minimizer.parity_scan(codes, lengths, k=cfg.k, m=cfg.m)
        return minimizer.fast_scan(codes, lengths, k=cfg.k, m=cfg.m)

    def count_reads(
        self, reads: Sequence[str], start_id: int = 0
    ) -> Tuple[count_ops.CountedTable, PhaseStats]:
        """Count a full read set in parity mode (batching and merge here).

        One batch is pruned directly; several are counted with cutoff -1,
        merged, then pruned (a group's occurrences may span batches).
        Every batch is scanned first, then counted, so ``wall_s`` holds
        ``batch``, ``scan`` and ``count`` (the merge included) apart.  The
        valid windows are summed on the device and read back once.
        """
        cfg = self.config
        stats = PhaseStats(n_reads=len(reads))
        with profiling.PhaseClock(stats, self.device, phase="batch") as clock:
            batches = reads_io.batch_reads(
                reads, cfg.max_read_len, cfg.batch_reads, start_id=start_id,
                parity_chars=cfg.parity,
            )
            if not batches:
                raise ValueError("no reads")
            # every batch but a lone one has the same number of rows, so the
            # stream index of a slot is its row in the whole set times n_win
            if len(batches) > 1:
                batches[-1] = reads_io.pad_batch(batches[-1], cfg.batch_reads)
            clock.start("scan")
            n_windows = torch.zeros((), dtype=torch.int64, device=self.device)
            scanned = []
            with stream_io.feed_read_batches(batches, self.device) as feeder:
                for codes, lengths, rids in feeder:
                    recs = self.scan(codes, lengths)
                    n_windows += recs.valid.sum()
                    scanned.append((recs, rids))
            clock.start("count")
            cutoff = cfg.abundance_cutoff if len(scanned) == 1 else -1
            rows_x_win = cfg.batch_reads * cfg.windows_per_read
            per_batch = [
                count_ops.count_and_prune(recs, rids, cutoff=cutoff,
                                          stream_offset=bi * rows_x_win)
                for bi, (recs, rids) in enumerate(scanned)
            ]
            del scanned
            if len(per_batch) == 1:
                counted = per_batch[0]
            else:
                counted = count_ops.merge_sorted_tables(per_batch, cutoff=cfg.abundance_cutoff)
            del per_batch
            stats.n_windows = int(n_windows)
            stats.entries_pre_prune = int(counted.n_entries)
            stats.entries_post_prune = int(counted.n_kept)
        return counted, stats


class FastAssembler:
    """Throughput pipeline: true canonical k-mers, device dBG compaction."""

    def __init__(self, config: Optional[PipelineConfig] = None, device="cuda"):
        self.config = config or PipelineConfig(parity=False)
        if self.config.parity:
            raise ValueError("FastAssembler requires parity=False config")
        if self.config.k % 2 == 0:
            # fail before any device work: the dBG phase needs odd k
            raise ValueError(
                "fast-mode assembly requires odd k (reverse-complement "
                f"palindromes break dBG strand pairing); got k={self.config.k}"
            )
        self.device = _check_device(device, "FastAssembler")
        self.counter = CountPipeline(self.config, self.device)

    def load(self, path: str) -> List[str]:
        with profiling.span("load"):
            return reads_io.load_reads_fast(path)

    def unitigs_from_sequences(
        self, sequences: Sequence[str]
    ) -> Tuple[List[str], PhaseStats]:
        """Assemble from arbitrarily long sequences (contigs, genomes).

        Sequences longer than max_read_len are split into k-1-overlapping
        chunks so every window is scanned exactly once.
        """
        cfg = self.config
        chunks: List[str] = []
        for s in sequences:
            if len(s) <= cfg.max_read_len:
                chunks.append(s)
            else:
                chunks.extend(
                    reads_io.chunk_long_sequence(s, cfg.max_read_len, cfg.k)
                )
        return self.unitigs(chunks)

    def unitigs(
        self, reads: Sequence[str], mesh=None
    ) -> Tuple[List[str], PhaseStats]:
        cfg = self.config
        if mesh is not None:
            return self._unitigs_sharded(reads, mesh)
        n_batches = -(-len(reads) // cfg.batch_reads)
        total_slots = n_batches * cfg.batch_reads * cfg.windows_per_read
        if total_slots * 8 > cfg.outofcore_bytes:
            return self._unitigs_outofcore(reads, total_slots)
        stats = PhaseStats(n_reads=len(reads))
        with profiling.PhaseClock(stats, self.device) as clock:
            combined, _ = self._flat_fast_records(reads, stats, clock)
            clock.start("count")
            kc = count_ops.count_keys(
                combined, cutoff=cfg.abundance_cutoff, hybrid_sort=cfg.hybrid_sort
            )
            stats.entries_pre_prune = int((kc.group_start & kc.valid).sum())
            stats.entries_post_prune = int(kc.keep.sum())
            kmer, valid = count_ops.kept_keys_sorted(kc)
            del kc, combined
            # the kept keys sit at the front of the padded table: the graph is
            # built over them alone (same node ids, so the same unitigs)
            n_nodes = stats.entries_post_prune
            kmer, valid = kmer[:n_nodes], valid[:n_nodes]
            graph = _extension_graph(kmer, valid, k=cfg.k, clock=clock)
            clock.start("materialize")
            out = dbg.materialize_unitigs(kmer, valid, graph, cfg.k)
        stats.entries_post_extension = len(out)
        return out, stats

    def _unitigs_outofcore(self, reads: Sequence[str], total_slots: int):
        """The record set exceeds ``outofcore_bytes``: hash-partitioned
        multi-pass counting (ops/outofcore.py), re-scanning every batch a
        pass; then links and jump with their own switches, and the device
        materializer.  ``wall_s``: batch, count (every pass: scans,
        extraction, partition counts), links, jump, materialize.
        ``n_windows`` is the window slots, as in the JAX package's branch."""
        cfg = self.config
        stats = PhaseStats(n_reads=len(reads))
        with profiling.PhaseClock(stats, self.device, phase="batch") as clock:
            batches = reads_io.batch_reads(reads, cfg.max_read_len, cfg.batch_reads)
            if len(batches) > 1:
                batches[-1] = reads_io.pad_batch(batches[-1], cfg.batch_reads)
            clock.start("count")
            batch_keys = _batch_source(
                batches, self.device,
                lambda b, codes, lengths, rids:
                    self.counter.scan(codes, lengths).kmer.reshape(-1))
            partitions = max(1, int(np.ceil(total_slots * 8 / (cfg.outofcore_bytes / 3))))
            pc = outofcore.partitioned_count(
                batch_keys, len(batches), partitions=partitions,
                cutoff=cfg.abundance_cutoff, hybrid_sort=cfg.hybrid_sort)
            stats.n_windows = total_slots
            stats.entries_pre_prune = pc.n_distinct
            stats.entries_post_prune = pc.n_kept
            kmer, valid = pc.kmer, pc.valid
            del pc
            graph = _extension_graph(
                kmer, valid, k=cfg.k, clock=clock, link_budget=cfg.link_budget_bytes,
                bulk_jump_states=cfg.bulk_jump_states)
            clock.start("materialize")
            out, _, _ = dbg.materialize_unitigs_device(kmer, valid, graph, cfg.k)
        stats.entries_post_extension = len(out)
        return out, stats

    def _flat_fast_records(self, reads: Sequence[str], stats: PhaseStats,
                           clock: profiling.PhaseClock, with_rids: bool = False):
        """Batch the reads, scan all batches and flatten their records.

        Returns (records, rid_flat): rid_flat is None unless with_rids.
        """
        cfg = self.config
        clock.start("batch")
        batches = reads_io.batch_reads(reads, cfg.max_read_len, cfg.batch_reads)
        if not batches:
            raise ValueError("no reads")
        if len(batches) > 1:
            batches[-1] = reads_io.pad_batch(batches[-1], cfg.batch_reads)
        clock.start("scan")
        kmers, valids, rid_parts = [], [], []
        # the valid windows are summed on the device and read back once,
        # after the last batch: the scan loop itself never waits for the card
        n_windows = torch.zeros((), dtype=torch.int64, device=self.device)
        with stream_io.feed_read_batches(batches, self.device) as feeder:
            for codes, lengths, rids in feeder:
                recs = self.counter.scan(codes, lengths)
                kmers.append(recs.kmer.reshape(-1))
                valids.append(recs.valid.reshape(-1))
                if with_rids:
                    rid_parts.append(
                        rids[:, None].expand(recs.kmer.shape).reshape(-1)
                    )
                n_windows += recs.valid.sum()
        stats.n_windows += int(n_windows)
        # the main path throws the minimizers away (routing in the
        # multi-device path is what needs them)
        combined = minimizer.WindowRecords(
            mmer=torch.zeros((0,), dtype=torch.int32, device=self.device),
            kmer=torch.cat(kmers),
            valid=torch.cat(valids),
        )
        rid_flat = torch.cat(rid_parts) if with_rids else None
        return combined, rid_flat

    def unitigs_with_coverage(
        self, reads: Sequence[str], mesh=None
    ) -> Tuple[List[str], np.ndarray, np.ndarray, PhaseStats]:
        """Fast-mode unitigs plus per-unitig abundance coverage.

        Returns (unitigs, occ_sum, n_kmers, stats): occ_sum[i] /
        n_kmers[i] is unitig i's mean k-mer occurrence count.
        """
        cfg = self.config
        if mesh is not None:
            return self._unitigs_cov_sharded(reads, mesh)
        stats = PhaseStats(n_reads=len(reads))
        with profiling.PhaseClock(stats, self.device) as clock:
            combined, _ = self._flat_fast_records(reads, stats, clock)
            clock.start("count")
            kc = count_ops.count_keys(
                combined, cutoff=cfg.abundance_cutoff, hybrid_sort=cfg.hybrid_sort
            )
            stats.entries_pre_prune = int((kc.group_start & kc.valid).sum())
            stats.entries_post_prune = int(kc.keep.sum())
            kmer, valid, counts = count_ops.kept_keys_sorted_with_counts(kc)
            del kc, combined
            n_nodes = stats.entries_post_prune
            kmer, valid, counts = kmer[:n_nodes], valid[:n_nodes], counts[:n_nodes]
            graph = _extension_graph(kmer, valid, k=cfg.k, clock=clock)
            clock.start("materialize")
            out, occ_sum, n_kmers = dbg.materialize_unitigs_cov(
                kmer, valid, graph, cfg.k, counts
            )
        stats.entries_post_extension = len(out)
        return out, occ_sum, n_kmers, stats

    def unitigs_with_read_ids(
        self, reads: Sequence[str], mesh=None
    ) -> Tuple[List[str], List[np.ndarray], PhaseStats]:
        """Fast-mode unitigs plus per-unitig supporting read ids.

        Returns (unitigs, read_ids, stats): read_ids[i] is the sorted
        array of distinct reads containing at least one of unitig i's
        canonical k-mers.  Builds a CSR (offsets, values) over the kept
        k-mer table from a (kmer, rid) sort, then merges member slices per
        unitig.
        """
        cfg = self.config
        if mesh is not None:
            return self._unitigs_rids_sharded(reads, mesh)
        stats = PhaseStats(n_reads=len(reads))
        with profiling.PhaseClock(stats, self.device) as clock:
            combined, rid_flat = self._flat_fast_records(
                reads, stats, clock, with_rids=True
            )
            clock.start("count")
            krc = count_ops.count_keys_rids(
                combined, rid_flat, cutoff=cfg.abundance_cutoff
            )
            stats.entries_pre_prune = int((krc.group_start & krc.valid).sum())
            # host-side CSR over kept groups (exact sizes, no padding)
            keep = krc.keep.cpu().numpy()
            rid_s = krc.read_id.cpu().numpy().astype(np.uint32)
            starts = np.flatnonzero(keep)
            counts = krc.count.cpu().numpy()[starts].astype(np.int64)
            stats.entries_post_prune = len(starts)
            offsets = np.zeros(len(starts) + 1, dtype=np.int64)
            np.cumsum(counts, out=offsets[1:])
            # flat occurrence indices: group g's occupy rid_s[starts[g] + j]
            within = np.arange(offsets[-1], dtype=np.int64) - np.repeat(
                offsets[:-1], counts
            )
            values = rid_s[np.repeat(starts, counts) + within]
            kmer = krc.kmer.cpu().numpy()[starts]
            return self._assemble_with_read_ids(kmer, offsets, values, stats, clock)

    def _assemble_with_read_ids(self, kmer, offsets, values, stats, clock):
        """Shared tail of the read-id channel: build the dBG over the kept
        sorted keys, materialize, and merge each unitig's member CSR
        slices into one sorted-distinct id array (single vectorized pass).
        """
        cfg = self.config
        kmer_dev = torch.from_numpy(kmer).to(self.device)
        valid = torch.ones(len(kmer), dtype=torch.bool, device=self.device)
        graph = _extension_graph(kmer_dev, valid, k=cfg.k, clock=clock)
        clock.start("materialize")
        out = dbg.materialize_unitigs(kmer, np.ones(len(kmer), bool), graph, cfg.k)
        u_off, u_rows = dbg.unitig_member_nodes(kmer, out, cfg.k)
        # one vectorized gather + dedup for ALL unitigs: flatten every
        # member node's CSR slice, tag each id with its unitig, lexsort,
        # and cut per-unitig sorted-distinct runs out of one array
        lens = offsets[u_rows + 1] - offsets[u_rows]
        tot = int(lens.sum())
        excl = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=excl[1:])
        pos = (
            np.arange(tot, dtype=np.int64)
            - np.repeat(excl[:-1], lens)
            + np.repeat(offsets[u_rows], lens)
        )
        ids_all = values[pos]
        member_unitig = np.repeat(
            np.arange(len(out), dtype=np.int64), np.diff(u_off)
        )
        uid_all = np.repeat(member_unitig, lens)
        order = np.lexsort((ids_all, uid_all))
        u_srt, id_srt = uid_all[order], ids_all[order]
        first = np.ones(tot, dtype=bool)
        first[1:] = (u_srt[1:] != u_srt[:-1]) | (id_srt[1:] != id_srt[:-1])
        u_u, id_u = u_srt[first], id_srt[first]
        u_counts = np.bincount(u_u, minlength=len(out))
        off2 = np.zeros(len(out) + 1, dtype=np.int64)
        np.cumsum(u_counts, out=off2[1:])
        per_unitig: List[np.ndarray] = [
            id_u[off2[i] : off2[i + 1]] for i in range(len(out))
        ]
        clock.stop()
        stats.entries_post_extension = len(out)
        return out, per_unitig, stats

    # ------------------------------------------------------------------
    # over a mesh
    # ------------------------------------------------------------------

    def _sharded_count(self, reads: Sequence[str], mesh, stats: PhaseStats,
                       clock: profiling.PhaseClock) -> shard_count.ShardedCount:
        """All reads as one batch, counted over the mesh with key ownership
        (minimizer mass is heavy-tailed and skews shard loads at high shard
        counts); the clock's phases ``batch`` and ``count`` (left running)."""
        cfg = self.config
        clock.start("batch")
        (batch,) = reads_io.batch_reads(reads, cfg.max_read_len)
        batch = reads_io.pad_batch(batch, -(-batch.n // mesh.n_shards) * mesh.n_shards)
        clock.start("count")
        sc = shard_count.sharded_count(
            batch.codes, batch.lengths, batch.read_ids, k=cfg.k, m=cfg.m, parity=False,
            cutoff=cfg.abundance_cutoff, mesh=mesh, route_by="key")
        overflow = mesh.total(sc.overflow)
        if overflow:
            raise RuntimeError(f"key routing overflow ({overflow})")
        stats.n_windows = mesh.total([v.sum() for v in sc.valid])
        stats.entries_pre_prune = mesh.total(
            [(g & v).sum() for g, v in zip(sc.group_start, sc.valid)])
        return sc

    def _sharded_graph(self, reads: Sequence[str], mesh, stats: PhaseStats,
                       clock: profiling.PhaseClock, *, with_counts: bool):
        """The mesh path up to the compacted graph.

        The graph is built over the kept keys padded to a multiple of the
        mesh size, as the JAX package builds it (node ids, so the unitig
        order, follow the pad).  Returns host (kmer, valid, counts or None,
        graph, wide); the clock's phases batch, count, links, jump (the
        jump's left running)."""
        cfg = self.config
        sc = self._sharded_count(reads, mesh, stats, clock)
        kmer, counts, stats.entries_post_prune = _sharded_kept_keys(sc, mesh, with_counts)
        del sc
        valid = [x != SENTINEL for x in kmer]
        clock.start("links")
        rows2 = 2 * kmer[0].shape[0]
        wide = cfg.wide_state_ids is True or (
            cfg.wide_state_ids == "auto" and rows2 * mesh.n_shards >= 1 << 31)
        links, ovf = part_dbg.partitioned_unitig_links_join(kmer, valid, k=cfg.k, mesh=mesh)
        _raise_on_overflow(mesh, ovf, "link-join routing")
        clock.start("jump")
        if wide:
            # the JAX package's wide (owner, local) jump: with int64 ids
            # here, the routed jump
            g, ovf = part_dbg.partitioned_pointer_jump(links, mesh=mesh)
            _raise_on_overflow(mesh, ovf, "jump routing")
        else:
            g = shard_dbg.sharded_pointer_jump(links, mesh=mesh)
        graph = dbg.CompactedGraph(*(torch.from_numpy(mesh.to_host(x).reshape(-1)) for x in g))
        kmer = mesh.to_host(kmer).reshape(-1)
        counts = None if counts is None else mesh.to_host(counts).reshape(-1)
        return kmer, kmer != SENTINEL, counts, graph, wide

    def _unitigs_sharded(self, reads: Sequence[str], mesh):
        """Counting and dBG compaction over the mesh; the host materializer
        (the bucketed one for wide ids, as in the JAX package)."""
        stats = PhaseStats(n_reads=len(reads))
        with profiling.PhaseClock(stats, *mesh.devices) as clock:
            kmer, valid, _, graph, wide = self._sharded_graph(
                reads, mesh, stats, clock, with_counts=False)
            clock.start("materialize")
            if wide:
                out = dbg.materialize_unitigs_partitioned(kmer, valid, graph, self.config.k)
            else:
                out = dbg.materialize_unitigs(kmer, valid, graph, self.config.k)
        stats.entries_post_extension = len(out)
        return out, stats

    def _unitigs_cov_sharded(self, reads: Sequence[str], mesh):
        """``unitigs_with_coverage`` over the mesh: the counts ride the
        kept-key sort."""
        stats = PhaseStats(n_reads=len(reads))
        with profiling.PhaseClock(stats, *mesh.devices) as clock:
            kmer, valid, counts, graph, _ = self._sharded_graph(
                reads, mesh, stats, clock, with_counts=True)
            clock.start("materialize")
            out, occ_sum, n_kmers = dbg.materialize_unitigs_cov(kmer, valid, graph,
                                                               self.config.k, counts)
        stats.entries_post_extension = len(out)
        return out, occ_sum, n_kmers, stats

    def _unitigs_rids_sharded(self, reads: Sequence[str], mesh):
        """``unitigs_with_read_ids`` over the mesh.  Each key is owned by one
        shard, so the shard-major concatenation of the kept groups is the
        global grouping: the host flattens them into the CSR, sorts the kept
        keys into dBG order and permutes the CSR alongside; the tail is the
        in-core one."""
        stats = PhaseStats(n_reads=len(reads))
        with profiling.PhaseClock(stats, *mesh.devices, self.device) as clock:
            sc = self._sharded_count(reads, mesh, stats, clock)
            lanes = shard_count.host_lanes(sc, mesh, ("kmer", "read_id", "count", "keep"))
            del sc
            s_idx, g_idx = np.nonzero(lanes["keep"])
            counts = lanes["count"][s_idx, g_idx].astype(np.int64)
            kmer = lanes["kmer"][s_idx, g_idx]
            stats.entries_post_prune = len(s_idx)
            offsets = np.zeros(len(s_idx) + 1, dtype=np.int64)
            np.cumsum(counts, out=offsets[1:])
            within = np.arange(offsets[-1], dtype=np.int64) - np.repeat(offsets[:-1], counts)
            base = s_idx.astype(np.int64) * lanes["keep"].shape[1] + g_idx
            values = lanes["read_id"].reshape(-1)[np.repeat(base, counts) + within].astype(
                np.uint32)
            # dBG order: sort the kept keys, permute the CSR alongside
            order = np.argsort(kmer, kind="stable")
            counts_s = counts[order]
            off_s = np.zeros(len(order) + 1, dtype=np.int64)
            np.cumsum(counts_s, out=off_s[1:])
            pos = (np.arange(offsets[-1], dtype=np.int64) - np.repeat(off_s[:-1], counts_s)
                   + np.repeat(offsets[:-1][order], counts_s))
            return self._assemble_with_read_ids(kmer[order], off_s, values[pos], stats, clock)


def _raise_on_overflow(mesh, overflow, what: str) -> None:
    total = mesh.total(overflow)
    if total:
        raise RuntimeError(f"{what} overflow ({total})")


def _sharded_kept_keys(sc: shard_count.ShardedCount, mesh, with_counts: bool):
    """The kept keys of a ShardedCount, sorted, cut into the mesh's row
    blocks.

    Every shard's kept keys (padded to the largest shard's count) are
    gathered to every device, sorted there once by the int64 key, and each
    local shard takes its rows of the first ``n_shards * ceil(n_kept /
    n_shards)`` (SENTINEL past the kept keys); only the shards' kept counts
    are read back.  Returns (kmer, counts or None: lists a local shard,
    n_kept)."""
    n = mesh.n_shards
    kept = [x[keep] for x, keep in zip(sc.kmer, sc.keep)]
    sizes = mesh.all_gather([torch.tensor([x.shape[0]], device=x.device) for x in kept])
    sizes = sizes[0].tolist()
    n_kept = sum(sizes)
    width = max(max(sizes), 1)
    rows = max(1, -(-n_kept // n))

    def gathered(parts, fill):
        return mesh.all_gather([torch.cat([x, x.new_full((width - x.shape[0],), fill)])
                                for x in parts])

    keys = gathered(kept, SENTINEL)
    cnts = (gathered([c[keep] for c, keep in zip(sc.count, sc.keep)], 0)
            if with_counts else [None] * len(keys))
    done = {}
    kmer, counts = [], []
    for s, key, cnt in zip(mesh.local, keys, cnts):
        if id(key) not in done:
            key_s, order = torch.sort(key)
            done[id(key)] = (key_s, None if cnt is None else cnt[order])
        key_s, cnt_s = done[id(key)]
        kmer.append(key_s[s * rows:(s + 1) * rows])
        counts.append(None if cnt_s is None else cnt_s[s * rows:(s + 1) * rows])
    return kmer, (counts if with_counts else None), n_kept


ENGINES = ("auto", "python", "native")


class ParityAssembler:
    """Bit-parity pipeline: device counting + host replay of the extension.

    The output equals the reference binary's byte for byte, line order
    included.
    """

    def __init__(self, config: Optional[PipelineConfig] = None, device="cuda"):
        self.config = config or PipelineConfig()
        if not self.config.parity:
            raise ValueError("ParityAssembler requires a parity config")
        self.device = _check_device(device, "ParityAssembler")
        self.counter = CountPipeline(self.config, self.device)

    def load(self, path: str) -> List[str]:
        # Any byte is accepted, as the reference accepts any byte (it
        # scores unknown characters as 'A'); reads containing non-ACGT
        # take the exact exception path (parity/nonacgt.py).
        with profiling.span("load"):
            return reads_io.load_reads_parity(path, self.config.read_length)

    def pruned_table(
        self, reads: Sequence[str]
    ) -> Tuple[table_ops.HostTable, PhaseStats]:
        self._reject_dirty(reads, "pruned_table (packed HostTable cannot "
                           "carry raw bytes; use pruned_table_dict)")
        if self._needs_outofcore(reads):
            return self._groups_outofcore(reads, self.config.abundance_cutoff)
        counted, stats = self.counter.count_reads(reads)
        with profiling.PhaseClock(stats, self.device, phase="extract"):
            host = table_ops.extract_groups(counted, pruned=True)
        return host, stats

    def _reject_dirty(self, reads: Sequence[str], where: str) -> None:
        if nonacgt.has_non_acgt(reads):
            raise NotImplementedError(
                f"reads contain non-ACGT bytes, unsupported by {where}; "
                "the in-core assemble()/pruned_table_dict() paths handle "
                "them exactly (parity/nonacgt.py)"
            )

    def _needs_outofcore(self, reads: Sequence[str]) -> bool:
        """True when the parity record set exceeds ``outofcore_bytes`` at
        20 bytes a window slot (the JAX package's five uint32 lanes, kept so
        both packages decide alike for one config)."""
        cfg = self.config
        n_batches = max(1, -(-len(reads) // cfg.batch_reads))
        total_slots = n_batches * cfg.batch_reads * cfg.windows_per_read
        return total_slots * 20 > cfg.outofcore_bytes

    def _groups_outofcore(self, reads: Sequence[str], cutoff: int, with_streams: bool = False,
                          checkpoint_dir: Optional[str] = None):
        """Hash-partitioned multi-pass parity counting (ops/outofcore.py).

        Bit parity holds: partitions cover complete (mmer, kmer) groups and
        every group carries its global first-seen stream index, so the
        merged table is in the reference's insertion order.  Returns (host
        table, stats) or, with ``with_streams``, (host table, streams,
        stats).  ``wall_s``: batch, count (every pass and the host merge).
        ``checkpoint_dir``: ``partitioned_count_parity``'s, resumable.
        """
        cfg = self.config
        stats = PhaseStats(n_reads=len(reads))
        with profiling.PhaseClock(stats, self.device, phase="batch") as clock:
            batches = reads_io.batch_reads(
                reads, cfg.max_read_len, cfg.batch_reads, parity_chars=True)
            if not batches:
                raise ValueError("no reads")
            if len(batches) > 1:
                batches[-1] = reads_io.pad_batch(batches[-1], cfg.batch_reads)
            n_win = cfg.windows_per_read
            total_slots = len(batches) * cfg.batch_reads * n_win
            clock.start("count")

            def records(b, codes, lengths, rids):
                recs = self.counter.scan(codes, lengths)
                rows, nw = recs.kmer.shape
                n = rows * nw
                stream = torch.arange(n, dtype=torch.int64, device=codes.device) + (
                    b * cfg.batch_reads * n_win)
                return (recs.mmer.reshape(n), recs.kmer.reshape(n),
                        rids[:, None].expand(rows, nw).reshape(n), stream)

            partitions = max(1, int(np.ceil(total_slots * 20 / (cfg.outofcore_bytes / 3))))
            out = outofcore.partitioned_count_parity(
                _batch_source(batches, self.device, records), len(batches),
                partitions=partitions, cutoff=cutoff,
                with_streams=with_streams, checkpoint_dir=checkpoint_dir)
            host, streams = out[0], (out[1] if with_streams else None)
            n_windows, overflows = out[-2:]
            if overflows:
                raise RuntimeError(
                    f"out-of-core parity counting: {overflows} records of a batch "
                    "exceeded their partition's staging cap (a heavily repeated "
                    "k-mer); raise outofcore_bytes (fewer, wider partitions, or "
                    "none past the limit)")
            stats.n_windows = n_windows
            stats.entries_pre_prune = len(host.mmer) if cutoff < 0 else 0
            stats.entries_post_prune = len(host.mmer) if cutoff >= 0 else 0
        if with_streams:
            return host, streams, stats
        return host, stats

    def _assemble_sharded(self, reads: Sequence[str], mesh, engine: str, verbose: bool,
                          routing: str):
        """Counting over the mesh (minimizer routing, any number of
        batches: each shard keeps its records across batches, so groups
        spanning batches stay whole), then the replay, as in core: each
        group carries its global first stream index.  Reads with non-ACGT
        bytes take the same exception regroup on the merged table.  The
        batches hold ``batch_reads`` rows rounded up to the mesh size, so a
        stream index is still row * windows_per_read + window.  ``wall_s``:
        batch, count, extract, replay."""
        cfg = self.config
        stats = PhaseStats(n_reads=len(reads))
        with profiling.PhaseClock(stats, *mesh.devices, phase="batch") as clock:
            n = mesh.n_shards
            rows = max(n, -(-cfg.batch_reads // n) * n)
            batches = [reads_io.pad_batch(b, rows) for b in reads_io.batch_reads(
                reads, cfg.max_read_len, rows, parity_chars=True)]
            clock.start("count")
            sc = shard_count.sharded_count_batches(
                batches, k=cfg.k, m=cfg.m, parity=True, cutoff=-1, mesh=mesh, routing=routing)
            overflow = mesh.total(sc.overflow)
            if overflow:
                raise RuntimeError(
                    f"minimizer routing overflow ({overflow} records); rerun with a larger "
                    "slack factor")
            stats.n_windows = mesh.total([v.sum() for v in sc.valid])
            stats.entries_pre_prune = mesh.total(
                [(g & v).sum() for g, v in zip(sc.group_start, sc.valid)])
            clock.start("extract")
            if nonacgt.has_non_acgt(reads):
                host, streams = shard_count.sharded_host_table_with_streams(sc, mesh)
                del sc
                groups = nonacgt.regroup_with_exceptions(
                    host, streams, reads, k=cfg.k, m=cfg.m, n_win=cfg.windows_per_read)
                return self._replay(
                    stats, clock, lambda: self._replay_string_groups(groups, engine, verbose))
            if engine == "native":
                groups = shard_count.sharded_groups_for_replay(sc, mesh)

                def run():
                    text, _ = replay_native.replay(*groups, cfg.k, cfg.m, cfg.abundance_cutoff,
                                                   verbose=verbose)
                    return text if verbose else text.splitlines()
            else:
                host, _ = shard_count.sharded_host_table_with_streams(sc, mesh)

                def run():
                    groups = replay_mod.groups_from_host_table(host, cfg.k, cfg.m)
                    return self._replay_string_groups(groups, engine, verbose)
            del sc
            return self._replay(stats, clock, run)

    def pruned_table_dict(self, reads: Sequence[str]) -> Dict:
        if nonacgt.has_non_acgt(reads):
            # raw-byte keys cannot ride the packed HostTable; the string
            # groups carry them
            return {
                (sig, km): list(map(int, reversed(ids)))
                for sig, km, ids in self.pruned_table_groups(reads)
            }
        host, _ = self.pruned_table(reads)
        return table_ops.decode_table(host, self.config.k, self.config.m)

    @staticmethod
    def _engine(engine: str) -> str:
        """'auto' -> 'native' if the C++ engine builds and loads, else
        'python'; the output is the same either way."""
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}; got {engine!r}")
        if engine == "auto":
            return "native" if replay_native.available() else "python"
        return engine

    @staticmethod
    def _replay(stats: PhaseStats, clock: profiling.PhaseClock, run):
        """Run the replay ``run()`` as the clock's last phase.  Unitig lines
        set ``entries_post_extension`` (their number); verbose text leaves
        it 0, as the JAX package leaves it on every parity run."""
        clock.start("replay")
        out = run()
        clock.stop()
        if isinstance(out, list):
            stats.entries_post_extension = len(out)
        return out, stats

    def assemble(
        self, reads: Sequence[str], engine: str = "auto", verbose: bool = False,
        mesh=None, routing: str = "padded",
    ):
        """Full parity pipeline -> unitig lines in the reference's exact
        print order.

        engine: 'python' (executable spec), 'native' (C++ engine), or
        'auto' (native if it builds, else python).
        verbose: return the print_kmer_read_ids text instead of unitig lines.
        mesh: count over this mesh (parallel/mesh.py); the replay is the
        same.  routing: "padded" or "ragged" record exchange on the mesh.
        Returns (lines or text, PhaseStats).
        """
        cfg = self.config
        engine = self._engine(engine)
        if mesh is not None:
            return self._assemble_sharded(reads, mesh, engine, verbose, routing)
        if nonacgt.has_non_acgt(reads):
            return self._assemble_nonacgt(reads, engine, verbose)
        if self._needs_outofcore(reads):
            # every group (cutoff -1): the replay prunes, as the reference does
            host_all, stats = self._groups_outofcore(reads, -1)
        else:
            counted, stats = self.counter.count_reads(reads)
            with profiling.PhaseClock(stats, self.device, phase="extract"):
                host_all = table_ops.extract_groups(counted, pruned=False)
            del counted
        if engine == "native":
            # the packed lanes go to the engine as they are
            def run():
                return replay_native.assemble(
                    host_all, cfg.k, cfg.m, cfg.abundance_cutoff, verbose=verbose)
        else:
            def run():
                groups = replay_mod.groups_from_host_table(host_all, cfg.k, cfg.m)
                return self._replay_string_groups(groups, engine, verbose)
        with profiling.PhaseClock(stats, self.device) as clock:
            return self._replay(stats, clock, run)

    def _nonacgt_groups(self, reads: Sequence[str]):
        """Device count + exact raw-byte regrouping (parity/nonacgt.py),
        unpruned, in insertion order: (groups, stats), the regrouping
        timed as the phase ``extract``."""
        cfg = self.config
        if self._needs_outofcore(reads):
            host_all, streams, stats = self._groups_outofcore(reads, -1, with_streams=True)
            counted = None
        else:
            counted, stats = self.counter.count_reads(reads)
        with profiling.PhaseClock(stats, self.device, phase="extract"):
            if counted is not None:
                host_all, streams = table_ops.extract_groups_with_streams(
                    counted, pruned=False
                )
                del counted
            groups = nonacgt.regroup_with_exceptions(
                host_all, streams, reads, k=cfg.k, m=cfg.m, n_win=cfg.windows_per_read,
            )
        return groups, stats

    def _assemble_nonacgt(self, reads: Sequence[str], engine: str, verbose: bool):
        """Exact parity for read sets containing non-ACGT bytes: the
        regrouped string groups (raw bytes preserved) feed either replay
        engine; pruning happens inside the replay as always."""
        groups, stats = self._nonacgt_groups(reads)
        with profiling.PhaseClock(stats, self.device) as clock:
            return self._replay(
                stats, clock, lambda: self._replay_string_groups(groups, engine, verbose)
            )

    def _replay_string_groups(self, groups, engine: str, verbose: bool):
        """Insertion-ordered string groups -> replay engine -> output."""
        cfg = self.config
        engine = self._engine(engine)
        if engine == "native":
            return replay_native.assemble_groups(
                groups, cfg.k, cfg.m, cfg.abundance_cutoff, verbose=verbose
            )
        rep = replay_mod.ReferenceReplay(cfg.k, cfg.m, cfg.abundance_cutoff)
        rep.build(groups)
        rep.prune()
        rep.expand()
        rep.extend_all(True)
        rep.extend_all(False)
        return rep.print_kmer_read_ids() if verbose else rep.print_kmers()

    def pruned_table_groups(self, reads: Sequence[str]):
        """Pruned table as STRING groups [(mmer, kmer, ids)] -- the form
        that can carry raw non-ACGT key bytes (the reference stores raw
        bytes in uncomplemented keys)."""
        groups, _ = self._nonacgt_groups(reads)
        return nonacgt.prune_groups(groups, self.config.abundance_cutoff)

    def expanded_table(self, reads: Sequence[str], engine: str = "auto"):
        """Post-extension expanded per-base-pair read-id table, queryable:
        {(mmer, unitig_key): [per-bp descending read-id list, one per base
        pair]} -- the state the reference only ever prints."""
        text, _ = self.assemble(reads, engine=engine, verbose=True)
        return parse_verbose_table(text)

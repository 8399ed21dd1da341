"""End-to-end assembly pipeline, fast mode, in core, one device.

ingest (host) -> scan -> count -> prune -> links -> pointer jump ->
materialize (host).  Every entry point takes ``device`` and defaults to
``"cuda"``: asked for a card on a machine without one it raises, it does
not carry on on the CPU.  The out-of-core and multi-device branches of
the JAX package are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from genome_assembly_tpu_torch.config import PipelineConfig
from genome_assembly_tpu_torch.io import reads as reads_io
from genome_assembly_tpu_torch.io import stream as stream_io
from genome_assembly_tpu_torch.ops import count as count_ops
from genome_assembly_tpu_torch.ops import dbg
from genome_assembly_tpu_torch.ops import minimizer


@dataclasses.dataclass
class PhaseStats:
    """Per-phase observability counters.

    wall_s holds the host-clock seconds of each phase of the last run;
    device phases are closed with a synchronize when they ran on a card.
    """

    n_reads: int = 0
    n_windows: int = 0
    entries_pre_prune: int = 0
    entries_post_prune: int = 0
    entries_post_extension: int = 0
    wall_s: Dict[str, float] = dataclasses.field(default_factory=dict)


class _PhaseClock:
    """Adds the seconds between two ``lap`` calls to ``stats.wall_s``."""

    def __init__(self, stats: PhaseStats, device: torch.device):
        self.stats = stats
        self.device = device
        self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.stats.wall_s[name] = self.stats.wall_s.get(name, 0.0) + now - self.t
        self.t = now


class CountPipeline:
    """Device-side scan shared by the count paths (fast branch only)."""

    def __init__(self, config: PipelineConfig):
        self.config = config

    def scan(self, codes: torch.Tensor, lengths: torch.Tensor) -> minimizer.WindowRecords:
        cfg = self.config
        if cfg.parity:
            raise NotImplementedError(
                "parity_scan is not ported yet (parity-mode slice)"
            )
        return minimizer.fast_scan(codes, lengths, k=cfg.k, m=cfg.m)


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
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "FastAssembler was asked for a CUDA device and this machine "
                "has none; pass device='cpu' to run on the CPU"
            )
        self.counter = CountPipeline(self.config)

    def load(self, path: str) -> List[str]:
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

    def _check_ported(self, mesh) -> None:
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (multi-device counting) is not ported yet "
                "(multi-device slice)"
            )

    def _graph(self, kmer: torch.Tensor, valid: torch.Tensor, clock: _PhaseClock):
        links = dbg.build_unitig_links_join(kmer, valid, k=self.config.k)
        clock.lap("links")
        graph = dbg.pointer_jump(links)
        clock.lap("jump")
        return graph

    def unitigs(
        self, reads: Sequence[str], mesh=None
    ) -> Tuple[List[str], PhaseStats]:
        cfg = self.config
        self._check_ported(mesh)
        n_batches = -(-len(reads) // cfg.batch_reads)
        total_slots = n_batches * cfg.batch_reads * cfg.windows_per_read
        if total_slots * 8 > cfg.outofcore_bytes:
            raise NotImplementedError(
                f"{total_slots} window slots exceed outofcore_bytes="
                f"{cfg.outofcore_bytes}; hash-partitioned out-of-core "
                "counting is not ported yet (out-of-core slice)"
            )
        stats = PhaseStats(n_reads=len(reads))
        clock = _PhaseClock(stats, self.device)
        combined, _ = self._flat_fast_records(reads, stats, clock)
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
        clock.lap("count")
        graph = self._graph(kmer, valid, clock)
        out = dbg.materialize_unitigs(kmer, valid, graph, cfg.k)
        clock.lap("materialize")
        stats.entries_post_extension = len(out)
        return out, stats

    def _flat_fast_records(self, reads: Sequence[str], stats: PhaseStats,
                           clock: _PhaseClock, with_rids: bool = False):
        """Batch the reads, scan all batches and flatten their records.

        Returns (records, rid_flat): rid_flat is None unless with_rids.
        """
        cfg = self.config
        batches = reads_io.batch_reads(reads, cfg.max_read_len, cfg.batch_reads)
        if not batches:
            raise ValueError("no reads")
        if len(batches) > 1:
            batches[-1] = reads_io.pad_batch(batches[-1], cfg.batch_reads)
        clock.lap("batch")
        kmers, valids, rid_parts = [], [], []
        # the valid windows are summed on the device and read back once,
        # after the last batch: the scan loop itself never waits for the card
        n_windows = torch.zeros((), dtype=torch.int64, device=self.device)
        for codes, lengths, rids in stream_io.feed_read_batches(batches, self.device):
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
        clock.lap("scan")
        return combined, rid_flat

    def unitigs_with_coverage(
        self, reads: Sequence[str], mesh=None
    ) -> Tuple[List[str], np.ndarray, np.ndarray, PhaseStats]:
        """Fast-mode unitigs plus per-unitig abundance coverage.

        Returns (unitigs, occ_sum, n_kmers, stats): occ_sum[i] /
        n_kmers[i] is unitig i's mean k-mer occurrence count.
        """
        cfg = self.config
        self._check_ported(mesh)
        stats = PhaseStats(n_reads=len(reads))
        clock = _PhaseClock(stats, self.device)
        combined, _ = self._flat_fast_records(reads, stats, clock)
        kc = count_ops.count_keys(
            combined, cutoff=cfg.abundance_cutoff, hybrid_sort=cfg.hybrid_sort
        )
        stats.entries_pre_prune = int((kc.group_start & kc.valid).sum())
        stats.entries_post_prune = int(kc.keep.sum())
        kmer, valid, counts = count_ops.kept_keys_sorted_with_counts(kc)
        del kc, combined
        n_nodes = stats.entries_post_prune
        kmer, valid, counts = kmer[:n_nodes], valid[:n_nodes], counts[:n_nodes]
        clock.lap("count")
        graph = self._graph(kmer, valid, clock)
        out, occ_sum, n_kmers = dbg.materialize_unitigs_cov(
            kmer, valid, graph, cfg.k, counts
        )
        clock.lap("materialize")
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
        self._check_ported(mesh)
        stats = PhaseStats(n_reads=len(reads))
        clock = _PhaseClock(stats, self.device)
        combined, rid_flat = self._flat_fast_records(
            reads, stats, clock, with_rids=True
        )
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
        clock.lap("count")
        return self._assemble_with_read_ids(kmer, offsets, values, stats, clock)

    def _assemble_with_read_ids(self, kmer, offsets, values, stats, clock):
        """Shared tail of the read-id channel: build the dBG over the kept
        sorted keys, materialize, and merge each unitig's member CSR
        slices into one sorted-distinct id array (single vectorized pass).
        """
        cfg = self.config
        kmer_dev = torch.from_numpy(kmer).to(self.device)
        valid = torch.ones(len(kmer), dtype=torch.bool, device=self.device)
        graph = self._graph(kmer_dev, valid, clock)
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
        clock.lap("materialize")
        stats.entries_post_extension = len(out)
        return out, per_unitig, stats

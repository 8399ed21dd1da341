"""Command line of the port.

  python -m genome_assembly_tpu_torch assemble reads.txt --k 6 --m 3 \\
      [--verbose-output] [--cpu]                    # parity mode (default)
  python -m genome_assembly_tpu_torch generate --genome-len 3000 --coverage 8 \\
      --read-len 64 --seed 5 --with-reverse --out r.txt
  python -m genome_assembly_tpu_torch assemble r.txt --mode fast --k 21 --m 7 \\
      [--cpu] [--hybrid-sort] [--metrics m.jsonl] [--trace DIR]
  python -m genome_assembly_tpu_torch count reads.txt [--checkpoint out.npz] [--metrics m.jsonl]
  python -m genome_assembly_tpu_torch generate --triangular --read-num 20 \\
      [--plot reads.png] [--starts-out starts.txt]
  python -m genome_assembly_tpu_torch plot verbose.txt [--genome-file g.txt] \\
      [--starts-file starts.txt] --outdir plots
  python -m genome_assembly_tpu_torch bench-scaling --devices 4 \\
      [--routing padded|ragged|two_level] [--batch-reads 4096] [--cpu]

``assemble``, ``count`` and ``bench-scaling`` run on the card unless
``--cpu`` is given (``bench-scaling``: a mesh of CPU shards; on the card,
shards share a card where there are fewer cards than shards).
``--metrics`` appends JSONL records (utils/metrics.py): ``assemble`` and
``count`` write one record a run, the JAX package's fields followed by the
run's own record of itself (``PhaseStats``): ``phase_s``, the seconds of
each phase; ``spans_s``, the seconds of each timed step in a phase
(``<phase>.<step>``); ``counts``, its counters (``h2d_bytes``,
``d2h_bytes``).  ``--trace`` writes a Chrome-trace JSON of the run, card
activity included (utils/profiling.py: the phases, their steps and the
load as ranges), ``count --checkpoint`` the counted table in the JAX
package's format (utils/checkpoint.py).  ``bench-scaling`` times the
sharded count of one random batch over 1, 2, 4 ... shards and prints a
JSON line a shard count (the JAX package's fields: shards, wall_s,
windows_per_s, scaling_eff).
"""

from __future__ import annotations

import argparse
import sys
import time


def _add_pipeline_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--k", type=int, default=31, help="k-mer size (<=31)")
    ap.add_argument("--m", type=int, default=4, help="minimizer size (<=15)")
    ap.add_argument("--cutoff", type=int, default=1, help="abundance cutoff")
    ap.add_argument(
        "--mode",
        choices=["parity", "fast"],
        default="parity",
        help="parity: bit-exact reference replication; fast: canonical path",
    )
    ap.add_argument("--read-length", type=int, default=101,
                    help="parity-mode fgets buffer size (reference READ_LENGTH)")
    ap.add_argument("--max-read-len", type=int, default=128)
    ap.add_argument("--batch-reads", type=int, default=16384)
    ap.add_argument("--metrics", default=None, help="append JSONL metrics here")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument(
        "--hybrid-sort",
        action="store_true",
        help="fast mode: sort the counted keys with library chunk sorts "
        "merged by the hand-written bitonic kernels instead of one library "
        "sort (same output)",
    )
    ap.add_argument(
        "--outofcore-gb",
        type=float,
        default=3.0,
        help="record gigabytes above which counting goes out of core "
        "(hash-partitioned multi-pass passes; fast mode at 8 bytes a window "
        "slot, parity mode at 20)",
    )


def _make_config(args):
    from genome_assembly_tpu_torch.config import PipelineConfig

    return PipelineConfig(
        k=args.k,
        m=args.m,
        abundance_cutoff=args.cutoff,
        read_length=args.read_length,
        parity=args.mode == "parity",
        batch_reads=args.batch_reads,
        max_read_len=args.max_read_len,
        hybrid_sort=args.hybrid_sort,
        outofcore_bytes=int(args.outofcore_gb * (1 << 30)),
    )


def _record_run(extra: dict, stats) -> None:
    """The run's own record of itself into a ``--metrics`` record."""
    extra["phase_s"] = dict(stats.wall_s)
    extra["spans_s"] = dict(stats.spans_s)
    extra["counts"] = dict(stats.counts)


def cmd_assemble(args) -> int:
    from genome_assembly_tpu_torch.io import reads as reads_io
    from genome_assembly_tpu_torch.models.pipeline import FastAssembler, ParityAssembler
    from genome_assembly_tpu_torch.utils.metrics import open_metrics
    from genome_assembly_tpu_torch.utils.profiling import annotate, maybe_trace

    cfg = _make_config(args)
    device = "cpu" if args.cpu else "cuda"
    log = open_metrics(args.metrics, run_id=f"assemble-{int(time.time())}")
    with maybe_trace(args.trace, cuda=not args.cpu):
        if cfg.parity:
            asm = ParityAssembler(cfg, device=device)
            reads = asm.load(args.reads_file)
            with log.phase("assemble", mode="parity", k=cfg.k, m=cfg.m) as extra, \
                    annotate("assemble"):
                if args.verbose_output:
                    text, stats = asm.assemble(reads, verbose=True)
                    sys.stdout.write(text)
                else:
                    lines, stats = asm.assemble(reads)
                    sys.stdout.write("\n".join(lines) + ("\n" if lines else ""))
                extra["entries_pre_prune"] = stats.entries_pre_prune
                extra["n_reads"] = stats.n_reads
                extra["n_windows"] = stats.n_windows
                _record_run(extra, stats)
            return 0
        asm = FastAssembler(cfg, device=device)
        with log.phase("assemble", mode="fast", k=cfg.k, m=cfg.m) as extra, \
                annotate("assemble"):
            if args.fasta:
                seqs = reads_io.load_fasta(args.reads_file)
                if args.coverage:
                    # long sequences chunked exactly as unitigs_from_sequences
                    chunks = []
                    for s in seqs:
                        if len(s) <= cfg.max_read_len:
                            chunks.append(s)
                        else:
                            chunks.extend(
                                reads_io.chunk_long_sequence(s, cfg.max_read_len, cfg.k)
                            )
                    unitigs, occ, nk, stats = asm.unitigs_with_coverage(chunks)
                else:
                    unitigs, stats = asm.unitigs_from_sequences(seqs)
            elif args.coverage:
                unitigs, occ, nk, stats = asm.unitigs_with_coverage(asm.load(args.reads_file))
            else:
                unitigs, stats = asm.unitigs(asm.load(args.reads_file))
            if args.coverage:
                lines = [
                    f"{u}\t{int(n)}\t{s / n:.3f}" for u, s, n in zip(unitigs, occ, nk)
                ]
            else:
                lines = unitigs
            sys.stdout.write("\n".join(lines) + ("\n" if lines else ""))
            extra["entries_post_prune"] = stats.entries_post_prune
            extra["n_unitigs"] = stats.entries_post_extension
            extra["n_windows"] = stats.n_windows
            _record_run(extra, stats)
    return 0


def cmd_count(args) -> int:
    """Count + prune only (``CountPipeline.count_reads``, either mode);
    optionally checkpoint the table."""
    from genome_assembly_tpu_torch.models.pipeline import (
        CountPipeline, FastAssembler, ParityAssembler)
    from genome_assembly_tpu_torch.utils.checkpoint import save_counted_table
    from genome_assembly_tpu_torch.utils.metrics import open_metrics

    cfg = _make_config(args)
    device = "cpu" if args.cpu else "cuda"
    log = open_metrics(args.metrics, run_id=f"count-{int(time.time())}")
    loader = ParityAssembler(cfg, device=device) if cfg.parity else FastAssembler(cfg, device=device)
    reads = loader.load(args.reads_file)
    pipeline = CountPipeline(cfg, device=loader.device)
    with log.phase("count", k=cfg.k, m=cfg.m) as extra:
        counted, stats = pipeline.count_reads(reads)
        extra["n_reads"] = stats.n_reads
        extra["n_windows"] = stats.n_windows
        extra["entries_pre_prune"] = stats.entries_pre_prune
        extra["entries_post_prune"] = stats.entries_post_prune
        _record_run(extra, stats)
    if args.checkpoint:
        save_counted_table(args.checkpoint, counted, cfg, phase="post-count")
        print(f"checkpoint written: {args.checkpoint}", file=sys.stderr)
    print(
        f"entries: {stats.entries_pre_prune} -> {stats.entries_post_prune} "
        f"({stats.n_windows} windows from {stats.n_reads} reads)",
        file=sys.stderr,
    )
    return 0


def cmd_generate(args) -> int:
    from genome_assembly_tpu_torch.io import datagen

    if args.triangular:
        genome, starts = datagen.generate_reads(
            genome_len=args.genome_len,
            read_len=args.read_len,
            read_num=args.read_num,
            seed=args.seed,
        )
        reads = datagen.reads_from_starts(genome, starts, args.read_len)
    else:
        genome, reads, starts = datagen.generate_coverage_reads(
            genome_len=args.genome_len,
            read_len=args.read_len,
            coverage=args.coverage,
            seed=args.seed,
            error_rate=args.error_rate,
            with_reverse=args.with_reverse,
        )
    datagen.write_reads(reads, args.out)
    if args.genome_out:
        with open(args.genome_out, "w") as f:
            f.write(genome + "\n")
    if args.starts_out:
        with open(args.starts_out, "w") as f:
            f.write("\n".join(str(int(s)) for s in starts) + "\n")
    if args.plot:
        from genome_assembly_tpu_torch.utils.plots import plot_reads

        plot_reads(starts, len(genome), args.read_len, args.plot)
    print(f"{len(reads)} reads -> {args.out}", file=sys.stderr)
    return 0


def cmd_plot(args) -> int:
    """Validation plots from a verbose (print_kmer_read_ids) dump: k-mers
    per m-mer bin, and with a genome the unitigs' placement on it."""
    import pathlib

    from genome_assembly_tpu_torch.utils import plots

    text = pathlib.Path(args.unitigs_file).read_text()
    bin_counts, unitigs = plots.parse_verbose_output(text)
    outdir = pathlib.Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    plots.plot_mmer_bins(bin_counts, str(outdir / "mmers.png"))
    if args.genome_file:
        genome = pathlib.Path(args.genome_file).read_text().strip()
        if args.starts_file:
            starts = [int(line) for line in pathlib.Path(args.starts_file).read_text().split()]
            plots.plot_unitig_placement_by_read_ids(
                unitigs, starts, genome, args.read_len, str(outdir / "kmers.png"))
        else:
            plots.plot_unitig_placement(
                [u for u, _ in unitigs], genome, str(outdir / "kmers.png"))
    print(
        f"{sum(bin_counts.values())} unitigs in {len(bin_counts)} bins -> {outdir}",
        file=sys.stderr,
    )
    return 0


def cmd_bench_scaling(args) -> int:
    """The sharded count of one random batch (``--batch-reads`` reads of 128
    bases, numpy seed 0) over 1, 2, 4 ... up to ``--devices`` shards: the
    best of three walls after one call that builds and loads the kernels,
    each closed by synchronising every card.  two_level routes over a
    (2, n / 2) mesh from 2 shards on."""
    import json

    import numpy as np
    import torch

    from genome_assembly_tpu_torch.parallel import mesh as mesh_lib
    from genome_assembly_tpu_torch.parallel import shard_count, two_level

    devices = ["cpu"] if args.cpu else None
    rng = np.random.default_rng(0)
    rows = args.batch_reads
    codes = torch.from_numpy(rng.integers(0, 4, size=(rows, 128), dtype=np.uint8))
    lengths = torch.full((rows,), 128, dtype=torch.int32)
    read_ids = torch.arange(rows, dtype=torch.int64)
    results = []
    n = 1
    while n <= args.devices:
        if args.routing == "two_level" and n >= 2:
            mesh = two_level.two_level_mesh(2, devices=devices, n_shards=n)
            routing = "two_level"
        else:
            mesh = mesh_lib.make_mesh(n, devices=devices)
            routing = args.routing if n > 1 else "padded"
        cards = sorted({d for d in mesh.devices if d.type == "cuda"}, key=str)
        batch = [x.to(mesh.devices[0]) for x in (codes, lengths, read_ids)]

        def run() -> None:
            shard_count.sharded_count(*batch, k=args.k, m=args.m, parity=False, cutoff=1,
                                      mesh=mesh, routing=routing)
            for d in cards:
                torch.cuda.synchronize(d)

        run()
        t_best = None
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            dt = time.perf_counter() - t0
            t_best = dt if t_best is None else min(t_best, dt)
        windows = rows * (128 - args.k + 1)
        results.append({"shards": n, "wall_s": t_best, "windows_per_s": windows / t_best})
        n *= 2
    base = results[0]["windows_per_s"]
    for r in results:
        r["scaling_eff"] = r["windows_per_s"] / (base * r["shards"])
        print(json.dumps(r), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="genome_assembly_tpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("assemble", help="full pipeline -> unitigs on stdout")
    a.add_argument("reads_file")
    a.add_argument("--verbose-output", action="store_true",
                   help="parity mode: print_kmer_read_ids format")
    a.add_argument("--fasta", action="store_true",
                   help="fast mode: treat input as FASTA (multi-line records, "
                        "long sequences chunked with k-1 overlap)")
    a.add_argument("--coverage", action="store_true",
                   help="fast mode: emit TSV unitig<TAB>n_kmers<TAB>mean_cov "
                        "(per-unitig mean k-mer occurrence count)")
    a.add_argument("--trace", default=None,
                   help="write a trace of the run (Chrome JSON) into this directory")
    _add_pipeline_args(a)
    a.set_defaults(fn=cmd_assemble)

    c = sub.add_parser("count", help="count+prune only, optional checkpoint")
    c.add_argument("reads_file")
    c.add_argument("--checkpoint", default=None)
    _add_pipeline_args(c)
    c.set_defaults(fn=cmd_count)

    g = sub.add_parser("generate", help="synthetic read sets")
    g.add_argument("--out", default="reads.txt")
    g.add_argument("--genome-out", default=None)
    g.add_argument("--genome-len", type=int, default=500)
    g.add_argument("--read-len", type=int, default=30)
    g.add_argument("--read-num", type=int, default=20)
    g.add_argument("--coverage", type=float, default=10.0)
    g.add_argument("--error-rate", type=float, default=0.0)
    g.add_argument("--seed", type=int, default=20)
    g.add_argument("--with-reverse", action="store_true")
    g.add_argument("--triangular", action="store_true",
                   help="reference-style triangular random walk positions")
    g.add_argument("--plot", default=None, help="write read-coverage bitmap PNG")
    g.add_argument("--starts-out", default=None,
                   help="write read start positions (one per line; read id "
                   "= line number)")
    g.set_defaults(fn=cmd_generate)

    p = sub.add_parser("plot", help="validation plots from verbose output")
    p.add_argument("unitigs_file")
    p.add_argument("--genome-file", default=None)
    p.add_argument("--starts-file", default=None,
                   help="read start positions (generate --starts-out); "
                   "switches kmers.png to read-id-based placement instead of "
                   "exact search")
    p.add_argument("--read-len", type=int, default=100,
                   help="read length for --starts-file placement windows")
    p.add_argument("--outdir", default="plots")
    p.set_defaults(fn=cmd_plot)

    b = sub.add_parser("bench-scaling", help="shard-count scaling benchmark")
    b.add_argument("--devices", type=int, default=8, help="the most shards to time")
    b.add_argument("--cpu", "--cpu-devices", dest="cpu", action="store_true",
                   help="a mesh of CPU shards")
    b.add_argument("--batch-reads", type=int, default=4096)
    b.add_argument("--k", type=int, default=21)
    b.add_argument("--m", type=int, default=7)
    b.add_argument("--routing", choices=["padded", "ragged", "two_level"], default="padded",
                   help="record exchange (two_level: within a slice, then across two "
                   "slices)")
    b.set_defaults(fn=cmd_bench_scaling)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

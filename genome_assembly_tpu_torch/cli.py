"""Command line of the port: ``assemble`` (parity and fast mode) and
``generate``.

  python -m genome_assembly_tpu_torch assemble reads.txt --k 6 --m 3 \\
      [--verbose-output] [--cpu]                    # parity mode (default)
  python -m genome_assembly_tpu_torch generate --genome-len 3000 --coverage 8 \\
      --read-len 64 --seed 5 --with-reverse --out r.txt
  python -m genome_assembly_tpu_torch assemble r.txt --mode fast --k 21 --m 7 \\
      [--cpu] [--hybrid-sort]

``assemble`` runs on the card unless ``--cpu`` is given.  The other
subcommands and options of the JAX package's CLI (``count``, ``plot``,
``bench-scaling``, ``--metrics``, ``--trace``) are not ported yet.
"""

from __future__ import annotations

import argparse
import sys


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


def cmd_assemble(args) -> int:
    from genome_assembly_tpu_torch.io import reads as reads_io
    from genome_assembly_tpu_torch.models.pipeline import FastAssembler, ParityAssembler

    cfg = _make_config(args)
    device = "cpu" if args.cpu else "cuda"
    if cfg.parity:
        asm = ParityAssembler(cfg, device=device)
        reads = asm.load(args.reads_file)
        if args.verbose_output:
            text, _ = asm.assemble(reads, verbose=True)
            sys.stdout.write(text)
        else:
            lines, _ = asm.assemble(reads)
            sys.stdout.write("\n".join(lines) + ("\n" if lines else ""))
        return 0
    asm = FastAssembler(cfg, device=device)
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
            unitigs, occ, nk, _ = asm.unitigs_with_coverage(chunks)
        else:
            unitigs, _ = asm.unitigs_from_sequences(seqs)
    elif args.coverage:
        unitigs, occ, nk, _ = asm.unitigs_with_coverage(asm.load(args.reads_file))
    else:
        unitigs, _ = asm.unitigs(asm.load(args.reads_file))
    if args.coverage:
        lines = [
            f"{u}\t{int(n)}\t{s / n:.3f}" for u, s, n in zip(unitigs, occ, nk)
        ]
    else:
        lines = unitigs
    sys.stdout.write("\n".join(lines) + ("\n" if lines else ""))
    return 0


def cmd_generate(args) -> int:
    from genome_assembly_tpu_torch.io import datagen

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
    print(f"{len(reads)} reads -> {args.out}", file=sys.stderr)
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
    _add_pipeline_args(a)
    a.set_defaults(fn=cmd_assemble)

    g = sub.add_parser("generate", help="synthetic read sets")
    g.add_argument("--out", default="reads.txt")
    g.add_argument("--genome-out", default=None)
    g.add_argument("--genome-len", type=int, default=500)
    g.add_argument("--read-len", type=int, default=30)
    g.add_argument("--coverage", type=float, default=10.0)
    g.add_argument("--error-rate", type=float, default=0.0)
    g.add_argument("--seed", type=int, default=20)
    g.add_argument("--with-reverse", action="store_true")
    g.add_argument("--starts-out", default=None,
                   help="write read start positions (one per line; read id "
                   "= line number)")
    g.set_defaults(fn=cmd_generate)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

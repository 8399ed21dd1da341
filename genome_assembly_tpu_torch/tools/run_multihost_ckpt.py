"""A checkpointed multi-batch distributed count over N processes, and its
kill-and-resume harness.

Launcher (spawns the workers on a free local port, waits, prints rank 0's
summary; stops every worker it started):

  python -m genome_assembly_tpu_torch.tools.run_multihost_ckpt --procs 2 \\
      --ckpt-dir DIR --device cpu [--die-after-batch N [--die-rank R]] \\
      [--out summary.json] [--rows 48] [dataset options]

Each worker joins the group, takes the global mesh (one shard a process)
and runs ``shard_count.sharded_count_batches`` over the generated reads in
batches of ``--rows`` rows (fixed, so a world of another size replays the
same batches; it must divide by every world's size), saving count shards
into ``--ckpt-dir`` after every batch.  ``--die-after-batch N`` makes the
rank ``--die-rank`` (default: every rank) SIGKILL itself right after the
checkpoint of batch N has committed; the others then fail on the broken
collective and the launcher stops them.  A relaunch on the same directory
resumes after batch N, on the same number of processes or another.

Rank 0 writes a JSON summary: processes, devices (= shards), n_batches,
resumed_from (the manifest's batches at start-up), overflow, entries and
digest (``run_multihost.table_digest``: the hash over the sorted kept
(mmer, kmer, count) triples, the JAX package's), and the seconds of the
run, of the checkpoint saves and of the load, and the checkpoint's bytes.
The launcher exits 0 only when every worker did.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import signal
import sys
import tempfile
import time

import torch

from genome_assembly_tpu_torch.io import datagen
from genome_assembly_tpu_torch.io import reads as reads_io
from genome_assembly_tpu_torch.parallel import distributed, shard_count
from genome_assembly_tpu_torch.tools import run_multihost
from genome_assembly_tpu_torch.utils import checkpoint as ckpt

MODULE = "genome_assembly_tpu_torch.tools.run_multihost_ckpt"

# the JAX package's kill-and-resume dataset (tools/run_multihost_ckpt.py)
DATASET = dict(genome_len=900, read_len=48, coverage=6.0, seed=33, k=11, m=5, cutoff=1,
               max_read_len=64, rows=48)


def batches_of(*, genome_len, read_len, coverage, seed, max_read_len, rows, **_):
    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=genome_len, read_len=read_len, coverage=coverage, seed=seed,
        with_reverse=True)
    return [reads_io.pad_batch(b, rows) for b in reads_io.batch_reads(reads, max_read_len, rows)]


def dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in pathlib.Path(path).glob("*") if p.is_file())


def worker(args) -> int:
    import torch.distributed as dist

    device = run_multihost._worker_device(args.device, args.worker)
    if device.type == "cpu":
        torch.set_num_threads(1)
    rank, world = distributed.init_multi_host(
        f"127.0.0.1:{args.port}", args.procs, args.worker, backend=args.backend,
        device=device)
    try:
        mesh = distributed.global_mesh(device)
        dataset = {name: getattr(args, name) for name in DATASET}
        batches = batches_of(**dataset)
        if args.rows % mesh.n_shards:
            raise SystemExit(f"--rows {args.rows} does not divide over {mesh.n_shards} shards")
        manifest = pathlib.Path(args.ckpt_dir) / "manifest.json"
        resumed_from = json.loads(manifest.read_text())["batches_done"] if manifest.exists() else 0
        seconds = {"save": 0.0, "load": 0.0}

        def timed(fn, name):
            def run(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    seconds[name] += time.perf_counter() - t0
            return run

        ckpt.save_count_shards = timed(ckpt.save_count_shards, "save")
        ckpt.load_count_shards = timed(ckpt.load_count_shards, "load")
        die = args.die_after_batch is not None and args.die_rank in (None, rank)

        def on_checkpoint(done):
            if die and done >= args.die_after_batch:
                os.kill(os.getpid(), signal.SIGKILL)

        t0 = time.perf_counter()
        sc = shard_count.sharded_count_batches(
            batches, k=args.k, m=args.m, parity=False, cutoff=args.cutoff, mesh=mesh,
            checkpoint_dir=args.ckpt_dir, checkpoint_every=1, on_checkpoint=on_checkpoint)
        overflow = mesh.total(sc.overflow)
        entries, digest = run_multihost.table_digest(sc, mesh, args.k, args.m)
        wall = time.perf_counter() - t0
        if rank == 0 and args.out:
            pathlib.Path(args.out).write_text(json.dumps(dict(
                processes=world, devices=mesh.n_shards, backend=dist.get_backend(),
                device=str(device), n_batches=len(batches), resumed_from=resumed_from,
                overflow=overflow, entries=entries, digest=digest, wall_seconds=wall,
                save_seconds=seconds["save"], load_seconds=seconds["load"],
                checkpoint_bytes=dir_bytes(args.ckpt_dir))))
    finally:
        dist.destroy_process_group()
    return 0


def worker_args(args, port: int, out: str):
    """The command line of every worker but its rank."""
    base = ["--procs", str(args.procs), "--port", str(port), "--device", args.device,
            "--timeout", str(args.timeout), "--out", out, "--ckpt-dir", str(args.ckpt_dir)]
    if args.backend:
        base += ["--backend", args.backend]
    if args.die_after_batch is not None:
        base += ["--die-after-batch", str(args.die_after_batch)]
    if args.die_rank is not None:
        base += ["--die-rank", str(args.die_rank)]
    for name in DATASET:
        base += [f"--{name.replace('_', '-')}", str(getattr(args, name))]
    return base


def run_world(args):
    """One world of ``args.procs`` workers: (exit codes, output tails,
    timed out, rank 0's summary or None)."""
    pathlib.Path(args.ckpt_dir).mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "summary.json")
        base = worker_args(args, run_multihost._free_port(), out)
        rcs, tails, timed_out = run_multihost.run_workers(
            MODULE, args.procs, lambda r: base + ["--worker", str(r)], timeout=args.timeout)
        summary = json.loads(pathlib.Path(out).read_text()) if not any(rcs) else None
    return rcs, tails, timed_out, summary


def launch(args) -> int:
    rcs, tails, timed_out, summary = run_world(args)
    if any(rcs):
        return run_multihost.report_failure(rcs, tails, timed_out)
    text = json.dumps(summary)
    if args.out:
        pathlib.Path(args.out).write_text(text)
    print(text, flush=True)
    return 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--procs", type=int, required=True, help="processes (= shards)")
    ap.add_argument("--ckpt-dir", required=True, help="the count shards' directory")
    ap.add_argument("--die-after-batch", type=int,
                    help="SIGKILL right after the checkpoint of this batch commits")
    ap.add_argument("--die-rank", type=int, help="only this rank dies (default: every rank)")
    ap.add_argument("--backend", choices=["gloo", "nccl"],
                    help="default: nccl on cards, gloo on the CPU")
    ap.add_argument("--device", default="cuda",
                    help="cpu, cuda (a card a rank) or cuda:N (every rank on card N)")
    ap.add_argument("--out", help="rank 0's JSON summary goes here too")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds a world may take")
    ap.add_argument("--worker", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    for name, default in DATASET.items():
        ap.add_argument(f"--{name.replace('_', '-')}", type=type(default), default=default)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.worker is not None:
        return worker(args)
    return launch(args)


if __name__ == "__main__":
    sys.exit(main())

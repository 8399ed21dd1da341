"""Count and assemble over one process a shard (torch.distributed).

Launcher (one command: spawns the workers on a free local port, waits,
prints rank 0's summary; stops every worker it started):

  python -m genome_assembly_tpu_torch.tools.run_multihost --procs 2 \\
      --backend gloo --device cpu [--out summary.json] [dataset options]

Worker (one a process; the launcher runs these):

  python -m genome_assembly_tpu_torch.tools.run_multihost --worker RANK \\
      --port PORT --procs N ...

Each worker joins the group (``parallel.distributed.init_multi_host``),
takes the global mesh (one shard a process) and runs the flat routers on
a generated read set: ``sharded_count`` with minimizer ownership and padded
blocks, again with key ownership and the ragged exchange, and
``FastAssembler.unitigs(reads, mesh=)``; then the two-level router
(``routing="two_level"``) over the ranks as a ``(procs // 2, 2)`` mesh
where ``procs`` is even, and as ``(procs // 4, 2, 2)`` where it is a
multiple of 4 from 8 up: a slice is consecutive ranks, so both axes cross
processes.  Rank 0 writes a JSON summary: the
kept-entry count and a content hash over the sorted kept (mmer, kmer,
count) triples (the JAX package's tools/run_multihost.py hashes the same
triples) of each count (``two_level_digest``, ``two_level3_digest``: null
where not run; a worker whose two-level hash differs from the flat one
fails), and the unitig count and a hash of the unitig
list.  ``summarize`` computes the same summary over
any mesh, so a one-process mesh of as many shards gives the result to hold
the workers' against.

``run_workers`` is the launcher the other process tools share
(``run_multihost_ckpt.py``, ``run_elastic.py``).

``--device cuda`` puts rank r on card ``r % device_count``; ``cuda:N``
puts every rank on card N (gloo only: NCCL needs a card a rank).  The
backend defaults to NCCL on cards and gloo on the CPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

import torch

from genome_assembly_tpu_torch.config import PipelineConfig
from genome_assembly_tpu_torch.io import datagen
from genome_assembly_tpu_torch.io import reads as reads_io
from genome_assembly_tpu_torch.models.pipeline import FastAssembler
from genome_assembly_tpu_torch.parallel import distributed, shard_count

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]

# the JAX package's multi-process dataset (tools/run_multihost.py)
DATASET = dict(genome_len=800, read_len=48, coverage=6.0, seed=2, k=11, m=5, cutoff=1,
               max_read_len=64)


def _digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj).encode()).hexdigest()


def table_digest(sc, mesh, k: int, m: int):
    """(kept entries, hash of the sorted kept (mmer, kmer, count) triples)
    of a sharded count."""
    table = shard_count.sharded_to_host_dict(sc, k, m, mesh)
    return len(table), _digest(sorted((mm, kk, len(v)) for (mm, kk), v in table.items()))


def two_level_shapes(n: int):
    """The two-level mesh shapes run over ``n`` shards: ``(n // 2, 2)``
    where n is even, ``(n // 4, 2, 2)`` where it is a multiple of 4 from 8."""
    return ((n // 2, 2) if n >= 2 and n % 2 == 0 else None,
            (n // 4, 2, 2) if n >= 8 and n % 4 == 0 else None)


def summarize(mesh, *, genome_len, read_len, coverage, seed, k, m, cutoff,
              max_read_len, two_level=None, two_level3=None) -> dict:
    """The flat counts and the fast-mode unitigs of the generated read set
    over ``mesh``: the overflow of both counts, the kept entries and the
    hash of each count's table (the two must agree), the unitigs and the
    hash of their list.  two_level, two_level3: meshes of as many shards
    with 2 and 3 axes; the two-level count over each must hash as the flat
    one (AssertionError otherwise)."""
    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=genome_len, read_len=read_len, coverage=coverage, seed=seed,
        with_reverse=True)
    n = mesh.n_shards
    (b,) = reads_io.batch_reads(reads, max_read_len)
    b = reads_io.pad_batch(b, n * -(-b.n // n))
    tables, overflow = {}, 0
    for routing, route_by in (("padded", "mmer"), ("ragged", "key")):
        sc = shard_count.sharded_count(b.codes, b.lengths, b.read_ids, k=k, m=m, parity=False,
                                       cutoff=cutoff, mesh=mesh, routing=routing,
                                       route_by=route_by)
        overflow += mesh.total(sc.overflow)
        tables[routing] = table_digest(sc, mesh, k, m)
        del sc
    for name, tl_mesh in (("two_level", two_level), ("two_level3", two_level3)):
        tables[name] = (None, None)
        if tl_mesh is None:
            continue
        sc = shard_count.sharded_count(b.codes, b.lengths, b.read_ids, k=k, m=m, parity=False,
                                       cutoff=cutoff, mesh=tl_mesh, routing="two_level")
        tl_overflow = tl_mesh.total(sc.overflow)
        got = table_digest(sc, tl_mesh, k, m)
        del sc
        if tl_overflow or got != tables["padded"]:
            raise AssertionError(f"the {name} count over {tl_mesh.shape} differs from the "
                                 f"flat one: {got}, overflow {tl_overflow}")
        tables[name] = got
    cfg = PipelineConfig(k=k, m=m, parity=False, abundance_cutoff=cutoff,
                         max_read_len=max_read_len)
    device = mesh.devices[mesh.local[0]]
    unitigs, stats = FastAssembler(cfg, device=device).unitigs(reads, mesh=mesh)
    return dict(shards=n, overflow=overflow, entries=tables["padded"][0],
                digest=tables["padded"][1], ragged_digest=tables["ragged"][1],
                two_level_digest=tables["two_level"][1],
                two_level3_digest=tables["two_level3"][1], n_unitigs=len(unitigs),
                unitig_digest=_digest(unitigs), entries_post_prune=stats.entries_post_prune,
                phase_seconds=stats.wall_s)


def _worker_device(spec: str, rank: int) -> torch.device:
    device = torch.device(spec)
    if device.type == "cuda" and device.index is None and torch.cuda.is_available():
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def worker(args) -> int:
    import torch.distributed as dist

    device = _worker_device(args.device, args.worker)
    if device.type == "cpu":
        torch.set_num_threads(1)
    rank, world = distributed.init_multi_host(
        f"127.0.0.1:{args.port}", args.procs, args.worker, backend=args.backend,
        device=device)
    try:
        mesh = distributed.global_mesh(device)
        shape2, shape3 = two_level_shapes(world)
        two_level = {name: distributed.global_mesh(device, shape=shape) if shape else None
                     for name, shape in (("two_level", shape2), ("two_level3", shape3))}
        backend = dist.get_backend()
        summary = dict(processes=world, backend=backend, device=str(device),
                       **summarize(mesh, **_dataset(args), **two_level))
        if rank == 0 and args.out:
            pathlib.Path(args.out).write_text(json.dumps(summary))
    finally:
        dist.destroy_process_group()
    return 0


def _dataset(args) -> dict:
    return {name: getattr(args, name) for name in DATASET}


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_workers(module: str, procs: int, worker_args, *, timeout: float):
    """Start ``python -m module *worker_args(rank)`` for every rank, from the
    repo root with it on PYTHONPATH, and wait.  A worker that fails (a
    non-zero exit, a signal) or the ``timeout`` stops every worker still
    running: none is left behind.  Returns (exit codes, the tail of each
    worker's output, whether the timeout struck)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO_ROOT)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(procs)]
    procs_ = [subprocess.Popen([sys.executable, "-m", module, *worker_args(r)], env=env,
                               cwd=str(REPO_ROOT), stdout=log, stderr=subprocess.STDOUT)
              for r, log in enumerate(logs)]
    deadline = time.monotonic() + timeout
    timed_out = False
    try:
        while any(p.poll() is None for p in procs_) and not any(p.returncode for p in procs_):
            timed_out = time.monotonic() > deadline
            if timed_out:
                break
            time.sleep(0.1)
    finally:
        for p in procs_:
            if p.poll() is None:
                p.kill()
            p.wait()
    tails = []
    for log in logs:
        log.seek(0)
        tails.append(log.read()[-3000:])
        log.close()
    return [p.returncode for p in procs_], tails, timed_out


def report_failure(rcs, tails, timed_out) -> int:
    for r, (rc, tail) in enumerate(zip(rcs, tails)):
        sys.stderr.write(f"--- worker {r} (exit {rc}) ---\n{tail}\n")
    return 124 if timed_out else 1


def launch(args) -> int:
    """Spawn the workers, wait (``--timeout`` seconds), print rank 0's
    summary.  A failed worker or the timeout stops every worker still
    running."""
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or os.path.join(tmp, "summary.json")
        base = ["--procs", str(args.procs), "--port", str(port), "--device", args.device,
                "--timeout", str(args.timeout), "--out", out]
        if args.backend:
            base += ["--backend", args.backend]
        for name in DATASET:
            base += [f"--{name.replace('_', '-')}", str(getattr(args, name))]
        rcs, tails, timed_out = run_workers(
            "genome_assembly_tpu_torch.tools.run_multihost", args.procs,
            lambda r: base + ["--worker", str(r)], timeout=args.timeout)
        if any(rcs):
            return report_failure(rcs, tails, timed_out)
        print(pathlib.Path(out).read_text(), flush=True)
    return 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--procs", type=int, required=True, help="processes (= shards)")
    ap.add_argument("--backend", choices=["gloo", "nccl"],
                    help="default: nccl on cards, gloo on the CPU")
    ap.add_argument("--device", default="cuda",
                    help="cpu, cuda (a card a rank) or cuda:N (every rank on card N)")
    ap.add_argument("--out", help="rank 0 writes its JSON summary here (the launcher "
                    "prints it too)")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds a worker may take")
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

#!/usr/bin/env python3
"""Time parity mode's replay against the size of the read set.

    python3 parity_replay_scaling.py [--limit SECONDS] [--cpu]

Every run is ``ParityAssembler(K=31, M=4, cutoff 1).assemble(engine="native")``
on reads of the shape of chip_smoke.py's parity phases: 100-bp reads of a
random genome at 50x (seed 7), written and read back through the fgets(101)
emulation.  Each run is a child process of its own, killed at ``--limit``
seconds.  The ladder's genomes (100, 200 and 300 kb) run one after the
other, beside the run of the 1 Mb genome (chip_smoke.py's ``parity_scale``
read set).  Before them the 1 Mb genome is counted, without the replay, at
10x, 20x and 50x: the replay's cost follows the table's entries, and this
shows how the entries move with coverage.  ``--cpu`` runs it all on the
CPU, on a machine without a card.

Prints the card's name and power limit, one JSON object a run, and
``{"ok": true}`` last.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import torch

from genome_assembly_tpu_torch.config import PipelineConfig
from genome_assembly_tpu_torch.io import datagen
from genome_assembly_tpu_torch.io import reads as reads_io
from genome_assembly_tpu_torch.models.pipeline import ParityAssembler

SHAPE = dict(read_len=100, seed=7, k=31, m=4, cutoff=1, max_read_len=128, batch_reads=65536)
LADDER = (100_000, 200_000, 300_000)
SCALE = 1_000_000
COVERAGES = (10, 20, 50)


def read_ids(genome_len: int, coverage: int):
    _, lines, _ = datagen.generate_coverage_reads(
        genome_len=genome_len, read_len=SHAPE["read_len"], coverage=coverage,
        seed=SHAPE["seed"])
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "reads.txt"
        datagen.write_reads(lines, str(path))
        return reads_io.load_reads_parity(str(path))


def assembler(device: str) -> ParityAssembler:
    return ParityAssembler(PipelineConfig(
        k=SHAPE["k"], m=SHAPE["m"], abundance_cutoff=SHAPE["cutoff"],
        max_read_len=SHAPE["max_read_len"], batch_reads=SHAPE["batch_reads"]), device=device)


def child(genome_len: int, device: str) -> None:
    """One timed assemble(); its result as a JSON line."""
    ids = read_ids(genome_len, 50)
    asm = assembler(device)
    t0 = time.perf_counter()
    lines, stats = asm.assemble(ids, engine="native")
    wall = time.perf_counter() - t0
    print(json.dumps(dict(
        genome_len=genome_len, coverage=50, read_ids=len(ids), finished=True,
        assemble_wall_seconds=wall, phase_seconds=dict(stats.wall_s),
        entries_pre_prune=stats.entries_pre_prune, entries_post_prune=stats.entries_post_prune,
        unitig_lines=len(lines))), flush=True)


def timed_child(genome_len: int, device: str, limit: float) -> dict:
    cmd = [sys.executable, __file__, "--child", str(genome_len)]
    if device == "cpu":
        cmd.append("--cpu")
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=limit)
    except subprocess.TimeoutExpired:
        return dict(genome_len=genome_len, coverage=50, finished=False,
                    killed_after_seconds=time.perf_counter() - t0)
    if r.returncode != 0:
        raise RuntimeError(f"genome {genome_len}: exit {r.returncode}\n{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def entries_by_coverage(genome_len: int, device: str) -> list:
    asm = assembler(device)
    out = []
    for coverage in COVERAGES:
        ids = read_ids(genome_len, coverage)
        _, stats = asm.counter.count_reads(ids)
        out.append(dict(genome_len=genome_len, coverage=coverage, read_ids=len(ids),
                        entries_pre_prune=stats.entries_pre_prune,
                        entries_post_prune=stats.entries_post_prune))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--limit", type=float, default=1200.0,
                    help="seconds a run may take before it is killed")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--child", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"
    if args.child is not None:
        child(args.child, device)
        return 0
    if not args.cpu:
        if not torch.cuda.is_available():
            print("parity_replay_scaling: no CUDA device", file=sys.stderr)
            return 1
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip(), flush=True)
    for row in entries_by_coverage(SCALE, device):
        print(json.dumps(dict(run="entries_by_coverage", **row)), flush=True)

    def run_ladder():
        return [timed_child(g, device, args.limit) for g in LADDER]

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        scale = pool.submit(timed_child, SCALE, device, args.limit)
        steps = pool.submit(run_ladder)
        for row in steps.result():
            print(json.dumps(dict(run="ladder", **row)), flush=True)
        print(json.dumps(dict(run="scale", **scale.result())), flush=True)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

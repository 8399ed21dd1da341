"""Scaling model of the sharded count and extension: exact wire traffic, priced.

    python -m genome_assembly_tpu_torch.tools.bench_scaling_model \\
        --link-bytes-per-s 450e9 --network-bytes-per-s 50e9
    python -m genome_assembly_tpu_torch.tools.bench_scaling_model \\
        --link-bytes-per-s 450e9 --network-bytes-per-s 50e9 --extension --time

The counterpart of the JAX package's ``tools/bench_scaling_model.py`` on the
port's ``parallel/comm_model.py``: for each shard count, one JSON line with
the rows ``count``, ``links`` and, where they apply, ``extension``,
``extension_wide``, ``extension_two_level``, ``count_2slice`` and
``count_two_level_phase``, the same keys as the JAX tool's.  The matrices
are exact (the routers are deterministic); records are priced at the port's
wire widths and its H100 rates (``comm_model.H100_*``).  The bandwidths
between cards and between hosts are required arguments: one card cannot
measure them.  The port's ids are int64, so JAX's wide extension is the
port's only one and ``extension_wide`` equals ``extension``.

Runs on the card unless ``--cpu`` is given: the reads are scanned and
counted, their links built and every matrix computed there.  ``--time``
also times ``sharded_count`` on a mesh of one shard a visible card, at most
the largest ``--shards`` (JAX's choice; ``--cpu``: one CPU shard), the best
of three after one call, as the CLI's ``bench-scaling`` does, and the
serial multi-batch count of ``--batches`` batches: the port has no
pipelined count, so there is no overlap gain to report.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, List

import numpy as np
import torch

from genome_assembly_tpu_torch.ops import count as count_ops
from genome_assembly_tpu_torch.ops import dbg, minimizer
from genome_assembly_tpu_torch.parallel import comm_model


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m genome_assembly_tpu_torch.tools.bench_scaling_model",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--link-bytes-per-s", type=float, required=True,
                    help="bytes a second a card sends to the other cards of its host "
                         "(e.g. NVLink)")
    ap.add_argument("--network-bytes-per-s", type=float, required=True,
                    help="bytes a second a card sends across hosts (the second level "
                         "of two-level routing)")
    ap.add_argument("--reads", type=int, default=8192)
    ap.add_argument("--read-len", type=int, default=128)
    ap.add_argument("--k", type=int, default=31)
    ap.add_argument("--m", type=int, default=7)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shards", type=int, nargs="+", default=[8, 16, 64, 256])
    ap.add_argument("--parity", action="store_true",
                    help="model parity mode's routing (minimizer owners)")
    ap.add_argument("--slices", type=int, default=2,
                    help="slices of the two-level model (shard counts divisible by it)")
    ap.add_argument("--route-by", choices=("mmer", "key"), default="mmer",
                    help="count ownership: minimizer hash or canonical-key hash")
    ap.add_argument("--extension", action="store_true",
                    help="also model the distributed extension (routed link join and "
                         "every pointer-jump round's gathers)")
    ap.add_argument("--batches", type=int, default=8,
                    help="batches of the multi-batch count model and of --time")
    ap.add_argument("--time", action="store_true",
                    help="also time sharded_count on a mesh of one shard a visible card "
                         "(at most the largest --shards)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is the card); with --time: one CPU shard")
    return ap


def _without_shards(d: dict) -> dict:
    return {k: v for k, v in d.items() if k != "shards"}


def main(argv=None, emit: Callable[[dict], None] = lambda e: print(json.dumps(e), flush=True)
         ) -> List[dict]:
    """Print one JSON line a shard count (and the --time lines); returns them."""
    args = parser().parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_scaling_model was asked for a CUDA device and this machine "
                           "has none; pass --cpu to run on the CPU")
    hw = comm_model.Hardware(link_bytes_per_s=args.link_bytes_per_s,
                             network_bytes_per_s=args.network_bytes_per_s)
    lines: List[dict] = []

    def out(line: dict) -> None:
        lines.append(line)
        emit(line)

    rng = np.random.default_rng(args.seed)
    codes = rng.integers(0, 4, size=(args.reads, args.read_len), dtype=np.uint8)
    lengths = np.full((args.reads,), args.read_len, dtype=np.int32)
    codes_t = torch.from_numpy(codes).to(device)
    lengths_t = torch.from_numpy(lengths).to(device)
    recs = minimizer.fast_scan(codes_t, lengths_t, k=args.k, m=args.m)
    kmer, valid = count_ops.kept_keys_sorted(count_ops.count_keys(recs, cutoff=0))
    del recs
    links = dbg.build_unitig_links_join(kmer, valid, k=args.k) if args.extension else None
    count_bytes = comm_model.COUNT_RECORD_BYTES

    for n in args.shards:
        if args.reads % n or kmer.shape[0] % n:
            out({"shards": n, "skipped": "indivisible"})
            continue
        cmat = comm_model.count_exchange_matrix(codes_t, lengths_t, k=args.k, m=args.m,
                                                n_shards=n, parity=args.parity,
                                                route_by=args.route_by)
        lmat = comm_model.links_exchange_matrix(kmer, valid, k=args.k, n_shards=n)
        count_phase = comm_model.phase_model(cmat, bytes_per_record=count_bytes,
                                             records_per_s=hw.count_records_per_s, hw=hw)
        count_pipe = comm_model.pipeline_model(cmat, n_batches=args.batches,
                                               bytes_per_record=count_bytes,
                                               records_per_s=hw.count_records_per_s, hw=hw)
        count_phase = {**count_phase, "n_batches": args.batches,
                       "eff_pipelined": count_pipe["eff_pipelined"]}
        link_phase = comm_model.phase_model(lmat, bytes_per_record=comm_model.LINK_RECORD_BYTES,
                                            records_per_s=hw.link_records_per_s, hw=hw)
        row = {"shards": n, "route_by": args.route_by, "count": _without_shards(count_phase),
               "links": _without_shards(link_phase)}
        if args.extension:
            ext = _without_shards(comm_model.extension_phase_model(lmat, links, n_shards=n, hw=hw))
            row["extension"] = ext
            row["extension_wide"] = dict(ext)
            if n >= 2 * args.slices and n % args.slices == 0:
                pmat, rmats, fmat = comm_model.jump_request_matrices(links, n_shards=n)
                gsum = pmat + fmat + sum(rmats)
                row["extension_two_level"] = {
                    "links": comm_model.two_level_split(lmat, n_slices=args.slices),
                    "jump_requests": comm_model.two_level_split(gsum, n_slices=args.slices),
                }
        if n >= 4 and n % 2 == 0:
            row["count_2slice"] = comm_model.two_level_split(cmat, n_slices=2)
        if n >= 2 * args.slices and n % args.slices == 0:
            row["count_two_level_phase"] = comm_model.two_level_phase_model(
                cmat, n_slices=args.slices, bytes_per_record=count_bytes,
                records_per_s=hw.count_records_per_s, n_batches=args.batches, hw=hw)
        out(row)

    if args.time:
        out_lines = _time(args, codes, lengths)
        for line in out_lines:
            out(line)
    return lines


def _time(args, codes: np.ndarray, lengths: np.ndarray) -> List[dict]:
    """--time: the one-batch sharded count, and the serial multi-batch count."""
    from genome_assembly_tpu_torch.io.reads import ReadBatch
    from genome_assembly_tpu_torch.parallel import mesh as mesh_lib
    from genome_assembly_tpu_torch.parallel import shard_count

    if args.cpu:
        devices, n = ["cpu"], 1
    else:
        devices, n = None, min(max(args.shards), torch.cuda.device_count())
    mesh = mesh_lib.make_mesh(n, devices=devices)
    cards = sorted({d for d in mesh.devices if d.type == "cuda"}, key=str)
    platform = "gpu" if cards else "cpu"
    kw = dict(k=args.k, m=args.m, parity=args.parity, cutoff=1, mesh=mesh)

    def best_of_three(fn) -> float:
        fn()
        best = None
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            for d in cards:
                torch.cuda.synchronize(d)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        return best

    rids = np.arange(args.reads, dtype=np.int64)
    wall = best_of_three(lambda: shard_count.sharded_count(
        codes, lengths, rids, route_by=args.route_by, **kw))
    lines = [{"timed_shards": n, "platform": platform, "wall_s": wall,
              "note": "compare against count.t_compute_s + t_comm_s of the model"}]
    rows = args.reads // args.batches
    rows -= rows % n
    if rows:
        batches = [ReadBatch(codes=codes[i * rows:(i + 1) * rows],
                             lengths=lengths[i * rows:(i + 1) * rows],
                             read_ids=rids[i * rows:(i + 1) * rows])
                   for i in range(args.batches)]
        serial = best_of_three(lambda: shard_count.sharded_count_batches(batches, **kw))
        lines.append({"timed_shards": n, "n_batches": args.batches, "serial": serial,
                      "note": "the port's multi-batch count runs the batches one after "
                              "another (no pipelined form): serial wall only"})
    return lines


if __name__ == "__main__":
    main()
    sys.exit(0)

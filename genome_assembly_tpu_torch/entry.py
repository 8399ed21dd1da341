"""Top-level entry points of the port: one device step of the main path, and
a dry run of one sharded step over a mesh of CPU shards.

The counterparts of the repo's ``__graft_entry__.entry`` and
``dryrun_multichip`` (which stay the JAX package's).

  python -m genome_assembly_tpu_torch.entry [N]    # the dry run on N CPU shards
"""

from __future__ import annotations

import numpy as np
import torch

from genome_assembly_tpu_torch.config import PipelineConfig
from genome_assembly_tpu_torch.io import datagen
from genome_assembly_tpu_torch.models.pipeline import FastAssembler, _check_device
from genome_assembly_tpu_torch.ops import count as count_ops
from genome_assembly_tpu_torch.ops import dbg, minimizer
from genome_assembly_tpu_torch.parallel import mesh as mesh_lib
from genome_assembly_tpu_torch.parallel import shard_count

K, M, CUTOFF = 31, 7, 1


def entry(device="cuda"):
    """(step, example_args): the device side of one fast-mode assembly step.

    step(codes, lengths) runs the main path's device phases on one read
    batch -- the fused scan (``fast_scan``: the K1 kernel on a card),
    ``count_keys`` and ``kept_keys_sorted``, ``build_unitig_links_join`` and
    ``pointer_jump`` over the kept keys, sentinel-padded to every window
    slot as in the JAX package -- and returns (n_kept, head, rank): the kept
    k-mers (a 0-d tensor) and the graph's chain heads and ranks, two states
    a slot (a pad state is its own head at rank 0).  The example arguments are the JAX
    entry's batch: 256 reads of 128 random bases from numpy's seed 0, on
    ``device``.
    """
    device = _check_device(device, "entry")

    def step(codes, lengths):
        recs = minimizer.fast_scan(codes, lengths, k=K, m=M)
        flat = minimizer.WindowRecords(
            mmer=recs.mmer[:0, 0], kmer=recs.kmer.reshape(-1), valid=recs.valid.reshape(-1))
        kc = count_ops.count_keys(flat, cutoff=CUTOFF)
        kmer, valid = count_ops.kept_keys_sorted(kc)
        graph = dbg.pointer_jump(dbg.build_unitig_links_join(kmer, valid, k=K))
        return kc.keep.sum(), graph.head, graph.rank

    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, 4, size=(256, 128), dtype=np.uint8)).to(device)
    lengths = torch.full((256,), 128, dtype=torch.int32, device=device)
    return step, (codes, lengths)


def dryrun_multichip(n_devices: int) -> None:
    """Run one sharded step on a one-process mesh of ``n_devices`` CPU
    shards: the sharded count of a small random batch with every routing
    (padded and ragged, minimizer and key owners, fast and parity mode) and
    no overflow, then ``FastAssembler.unitigs(mesh=)`` on a small read set,
    held equal to the single-device list.  Raises on any difference."""
    mesh = mesh_lib.make_mesh(n_devices, devices=["cpu"])
    k, m = 21, 7
    # a tiny batch (4 reads a shard): per-pair capacities shrink with the
    # shard count while minimizer skew does not, so slack grows with it
    slack = float(max(4, n_devices))
    rows = 4 * n_devices
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(rows, 64), dtype=np.uint8)
    lengths = np.full((rows,), 64, dtype=np.int32)
    read_ids = np.arange(rows, dtype=np.uint32)

    def count(**kw):
        kw = dict(dict(parity=False, routing="padded", route_by="mmer"), **kw)
        sc = shard_count.sharded_count(codes, lengths, read_ids, k=k, m=m, cutoff=0,
                                       mesh=mesh, slack=slack, **kw)
        overflow = mesh.total(sc.overflow)
        if overflow:
            raise AssertionError(f"routing overflow in the dry run ({kw}): {overflow}")
        return mesh.total([x.sum() for x in sc.keep])

    n_entries = count()
    if n_entries <= 0:
        raise AssertionError("the sharded count kept nothing")
    for kw in (dict(routing="ragged"), dict(route_by="key"), dict(route_by="key", routing="ragged")):
        if count(**kw) != n_entries:
            raise AssertionError(f"the sharded count with {kw} kept another number of entries")
    count(parity=True)

    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=600, read_len=48, coverage=6, seed=5, with_reverse=True)
    asm = FastAssembler(PipelineConfig(k=11, m=5, parity=False, max_read_len=64,
                                       batch_reads=3 * n_devices), device="cpu")
    on_mesh, _ = asm.unitigs(reads, mesh=mesh)
    alone, _ = asm.unitigs(reads)
    if on_mesh != alone or not alone:
        raise AssertionError("unitigs over the mesh differ from the single-device list")
    print(f"dryrun_multichip ok: {n_devices} CPU shards, {n_entries} entries, "
          f"{len(alone)} unitigs over the mesh == single device")


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)

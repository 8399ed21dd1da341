"""Top-level entry points of the port: one device step of the main path, and
a dry run of the sharded steps over meshes of CPU shards.

The counterparts of the repo's ``__graft_entry__.entry`` and
``dryrun_multichip`` (which stay the JAX package's).

  python -m genome_assembly_tpu_torch.entry [N]    # the dry run on N CPU shards
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch

from genome_assembly_tpu_torch.config import PipelineConfig
from genome_assembly_tpu_torch.io import datagen
from genome_assembly_tpu_torch.models.pipeline import FastAssembler, _check_device
from genome_assembly_tpu_torch.ops import count as count_ops
from genome_assembly_tpu_torch.ops import dbg, minimizer
from genome_assembly_tpu_torch.io import reads as reads_io
from genome_assembly_tpu_torch.parallel import halo
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
    """Run the sharded steps on one-process meshes of ``n_devices`` CPU
    shards: the sharded count of a small random batch with every routing
    (padded and ragged, minimizer and key owners, fast and parity mode) and
    no overflow; ``FastAssembler.unitigs(mesh=)`` on a small read set, held
    equal to the single-device list; for an even count the two-level count
    over ``(2, n/2)`` (and ``(2, 2, n/4)`` where n divides by 8) held to the
    flat one row for row; the halo exchange, every window of a sequence
    scanned once; and a checkpointed two-batch count stopped after one
    batch and resumed on half the shards, held to the uninterrupted count.
    Raises on any difference."""
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

    def flat_count(mesh_, **kw):
        sc = shard_count.sharded_count(codes, lengths, read_ids, k=k, m=m, parity=False,
                                       cutoff=0, mesh=mesh_, slack=slack, **kw)
        if mesh_.total(sc.overflow):
            raise AssertionError(f"routing overflow in the dry run over {mesh_.shape}")
        return sc

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

    shapes = []
    if n_devices % 2 == 0:
        shapes.append((2, n_devices // 2))
        if n_devices % 8 == 0:
            shapes.append((2, 2, n_devices // 4))
        flat = flat_count(mesh)
        for shape in shapes:
            got = flat_count(mesh_lib.make_mesh(devices=["cpu"], shape=shape),
                             routing="two_level")
            for name in shard_count.ShardedCount._fields:
                if not all(torch.equal(a, b) for a, b in zip(getattr(got, name),
                                                             getattr(flat, name))):
                    raise AssertionError(f"two-level {name} over {shape} differs from the flat "
                                         "count")

    seq = rng.integers(0, 4, size=(n_devices * 32,)).astype(np.uint8)
    segments, seg_lens = halo.split_sequence(seq, n_devices, k)
    ext, ext_lens = halo.haloed_segments(segments, seg_lens, k=k, mesh=mesh)
    windows = sorted(bytes(e[0, i:i + k].numpy()) for e, n in zip(ext, ext_lens)
                     for i in range(int(n) - k + 1))
    if windows != sorted(bytes(seq[i:i + k]) for i in range(len(seq) - k + 1)):
        raise AssertionError("the haloed segments do not scan every window once")

    half = mesh_lib.make_mesh(max(1, n_devices // 2), devices=["cpu"])
    brows = 3 * int(np.lcm(n_devices, half.n_shards))
    batches = [reads_io.pad_batch(b, brows) for b in reads_io.batch_reads(reads, 64, brows)][:2]
    kw = dict(k=11, m=5, parity=False, cutoff=1)
    whole = shard_count.sharded_count_batches(batches, mesh=mesh, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        shard_count.sharded_count_batches(batches[:1], mesh=mesh, checkpoint_dir=tmp, **kw)
        resumed = shard_count.sharded_count_batches(batches, mesh=half, checkpoint_dir=tmp,
                                                    **kw)
    if (half.total(resumed.overflow) or shard_count.sharded_to_host_dict(resumed, 11, 5, half)
            != shard_count.sharded_to_host_dict(whole, 11, 5, mesh)):
        raise AssertionError("the resumed checkpointed count differs from the uninterrupted one")
    print(f"dryrun_multichip ok: {n_devices} CPU shards, {n_entries} entries, "
          f"{len(alone)} unitigs over the mesh == single device, two-level over "
          f"{shapes or 'no mesh (odd count)'} == flat, {len(windows)} haloed windows, "
          f"{len(batches)} checkpointed batches resumed on {half.n_shards} shards")


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)

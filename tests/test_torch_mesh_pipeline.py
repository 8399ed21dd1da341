"""Port vs JAX package: both assemblers with ``mesh=`` (CPU meshes of 4 and 8).

Fast mode: ``FastAssembler.unitigs``, ``unitigs_with_coverage`` and
``unitigs_with_read_ids`` over the mesh equal the JAX package's over its
mesh of as many virtual devices -- the list in order, the coverage arrays,
the read ids and the counters -- and the port's single-device set (also
its order, narrow ids).  Parity mode: ``ParityAssembler.assemble(mesh=)``
reproduces the ``input_k6m3_*`` goldens byte for byte from
``tests/golden/input.txt``, clean reads and reads with non-ACGT bytes equal
the single-device output, padded and ragged.  Tolerance 0.
"""

import dataclasses
import functools
import pathlib

import numpy as np
import pytest

from genome_assembly_tpu.config import PipelineConfig as JConfig
from genome_assembly_tpu.io import datagen
from genome_assembly_tpu.models.pipeline import FastAssembler as JFast
from genome_assembly_tpu.models.pipeline import ParityAssembler as JParity
from genome_assembly_tpu.parallel import mesh as jmesh_lib
from genome_assembly_tpu_torch.config import PipelineConfig as TConfig
from genome_assembly_tpu_torch.models.pipeline import FastAssembler as TFast
from genome_assembly_tpu_torch.models.pipeline import ParityAssembler as TParity
from genome_assembly_tpu_torch.parallel import mesh as tmesh_lib

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
SHARDS = [4, 8]


@functools.lru_cache(maxsize=None)
def _meshes(n):
    return jmesh_lib.make_mesh(n), tmesh_lib.make_mesh(n, devices=["cpu"])


@functools.lru_cache(maxsize=None)
def _reads(genome_len=700, read_len=48, coverage=8, seed=13):
    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=genome_len, read_len=read_len, coverage=coverage, seed=seed,
        with_reverse=True)
    return reads


def _counters(stats):
    d = dataclasses.asdict(stats)
    d.pop("wall_s")
    return d


def _fast(wide, **kw):
    kw = {**dict(k=11, m=5, parity=False, max_read_len=64, wide_state_ids=wide), **kw}
    return JFast(JConfig(**kw)), TFast(TConfig(**kw), device="cpu")


# -- fast mode ---------------------------------------------------------------


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("wide", [False, True])
def test_unitigs_over_a_mesh_match_jax(n, wide):
    jm, tm = _meshes(n)
    reads = _reads()
    jasm, tasm = _fast(wide)
    want, wstats = jasm.unitigs(reads, mesh=jm)
    got, gstats = tasm.unitigs(reads, mesh=tm)
    assert got == want
    assert _counters(gstats) == _counters(wstats)
    assert set(gstats.wall_s) == {"batch", "count", "links", "jump", "materialize"}
    single, sstats = tasm.unitigs(reads)
    assert sorted(got) == sorted(single)
    assert _counters(gstats) == _counters(sstats)
    if not wide:
        # the graph over the mesh's pad has the single device's node ids
        assert got == single


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("wide", [False, True])
def test_coverage_over_a_mesh_matches_jax(n, wide):
    jm, tm = _meshes(n)
    reads = _reads(600, 48, 9, 17)
    jasm, tasm = _fast(wide)
    wu, wo, wn, _ = jasm.unitigs_with_coverage(reads, mesh=jm)
    gu, go, gn, _ = tasm.unitigs_with_coverage(reads, mesh=tm)
    assert gu == wu
    np.testing.assert_array_equal(go, np.asarray(wo))
    np.testing.assert_array_equal(gn, np.asarray(wn))
    su, so, sn, _ = tasm.unitigs_with_coverage(reads)
    assert sorted(zip(gu, go.tolist(), gn.tolist())) == sorted(zip(su, so.tolist(), sn.tolist()))


@pytest.mark.parametrize("n", SHARDS)
def test_read_ids_over_a_mesh_match_jax(n):
    jm, tm = _meshes(n)
    reads = _reads(500, 40, 8, 33)
    jasm, tasm = _fast(False)
    wu, wids, wstats = jasm.unitigs_with_read_ids(reads, mesh=jm)
    gu, gids, gstats = tasm.unitigs_with_read_ids(reads, mesh=tm)
    assert gu == wu
    assert len(gids) == len(wids)
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(gids, wids))
    assert _counters(gstats) == _counters(wstats)
    su, sids, _ = tasm.unitigs_with_read_ids(reads)
    assert (sorted((u, tuple(i.tolist())) for u, i in zip(gu, gids))
            == sorted((u, tuple(i.tolist())) for u, i in zip(su, sids)))


def test_mesh_path_refuses_overflow(monkeypatch):
    """All reads alike: one key owns every record; with a tiny slack the
    mesh path raises, it does not assemble a table that lost records."""
    from genome_assembly_tpu_torch.parallel import shard_count

    _, tm = _meshes(8)
    _, tasm = _fast(False)
    count = shard_count.sharded_count
    monkeypatch.setattr(shard_count, "sharded_count",
                        lambda *a, **kw: count(*a, slack=0.05, **kw))
    with pytest.raises(RuntimeError, match="overflow"):
        tasm.unitigs(["A" * 48] * 64, mesh=tm)


# -- parity mode -------------------------------------------------------------


def _golden(name):
    return (GOLDEN / name).read_text()


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("routing", ["padded", "ragged"])
@pytest.mark.parametrize("engine", ["python", "native"])
def test_parity_over_a_mesh_reproduces_the_goldens(n, routing, engine):
    _, tm = _meshes(n)
    asm = TParity(TConfig(k=6, m=3, max_read_len=32, batch_reads=64), device="cpu")
    reads = asm.load(str(GOLDEN / "input.txt"))
    lines, stats = asm.assemble(reads, engine=engine, mesh=tm, routing=routing)
    assert lines == _golden("input_k6m3_unitigs.txt").splitlines()
    assert stats.entries_post_extension == len(lines)
    text, _ = asm.assemble(reads, engine=engine, verbose=True, mesh=tm, routing=routing)
    assert text == _golden("input_k6m3_verbose.txt")


@pytest.mark.parametrize("routing", ["padded", "ragged"])
def test_parity_over_a_mesh_in_several_batches_matches_jax(routing):
    """Reads spanning several batches (groups spanning batches) == the JAX
    package's single-device output and its mesh output, line for line."""
    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=500, read_len=30, coverage=8, seed=21, with_reverse=False)
    kw = dict(k=8, m=4, max_read_len=32, batch_reads=40)
    jm, tm = _meshes(8)
    assert len(reads) > kw["batch_reads"]
    want, _ = JParity(JConfig(**kw)).assemble(reads)
    assert JParity(JConfig(**kw)).assemble(reads, mesh=jm, routing=routing)[0] == want
    got, stats = TParity(TConfig(**kw), device="cpu").assemble(reads, mesh=tm, routing=routing)
    assert got == want
    assert set(stats.wall_s) == {"batch", "count", "extract", "replay"}


def _dirty_reads(seed=7, n=40, length=30):
    """The non-ACGT fixture of tests/test_parity_nonacgt.py."""
    rng = np.random.default_rng(seed)
    reads = ["".join(rng.choice(list("ACGT"), size=length)) for _ in range(n)]
    reads[0] = reads[0][:5] + "N" + reads[0][6:]
    reads[1] = reads[1][:3] + "n" + reads[1][4:]
    reads[2] = reads[2].lower()
    reads[3] = reads[3][:10] + "X" + reads[3][11:]
    reads[4] = "N" + reads[4][1:]
    return reads + reads


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("routing", ["padded", "ragged"])
def test_parity_dirty_reads_over_a_mesh_match_jax(n, routing):
    """Non-ACGT reads take the exception regroup on the merged table; the
    batches round ``batch_reads`` up to the mesh size (30 -> 32 rows), so
    the stream stride is the batch's row count."""
    jm, tm = _meshes(n)
    reads = _dirty_reads()
    kw = dict(k=6, m=3, max_read_len=32, batch_reads=30)
    want, _ = JParity(JConfig(**kw)).assemble(reads, engine="native", mesh=jm, routing=routing)
    assert any(not frozenset("ACGT").issuperset(line) for line in want)
    tasm = TParity(TConfig(**kw), device="cpu")
    single, _ = tasm.assemble(reads, engine="native")
    assert single == want
    for engine in ("python", "native"):
        got, _ = tasm.assemble(reads, engine=engine, mesh=tm, routing=routing)
        assert got == want

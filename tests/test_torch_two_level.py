"""Port vs JAX package: two-level routing over meshes of slices.

The same numpy-seeded batches (``tests/test_two_level.py``'s) go through the
JAX ``two_level`` functions on the conftest's 8 virtual devices shaped
(2, 4), (4, 2) and (2, 2, 2), and through the port's on one-process CPU
meshes of those shapes.  The count is compared through
``convert.sharded_count_to_lanes`` at tolerance 0 (every row's flags and
counts, the lanes of every row that holds a record), and against the port's
own flat ``routing="padded"`` count row for row, every lane.  The links
join equals JAX's two-level join and the port's flat join.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from genome_assembly_tpu.io import datagen
from genome_assembly_tpu.io import reads as jreads
from genome_assembly_tpu.parallel import part_dbg as jpart
from genome_assembly_tpu.parallel import shard_count as jsc
from genome_assembly_tpu.parallel import two_level as jtl
from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.parallel import mesh as tmesh_lib
from genome_assembly_tpu_torch.parallel import part_dbg as tpart
from genome_assembly_tpu_torch.parallel import shard_count as tsc
from genome_assembly_tpu_torch.parallel import two_level as ttl

from test_torch_part_dbg import _keys, _sharded_keys, _whole
from test_torch_shard_count import assert_same_count

SHAPES = [(2, 4), (4, 2), (2, 2, 2)]


def _batch(n_reads=64, read_len=40, max_len=48, seed=2):
    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=600, read_len=read_len, coverage=6, seed=seed, with_reverse=True)
    reads = (reads * ((n_reads // len(reads)) + 1))[:n_reads]
    (b,) = jreads.batch_reads(reads, max_len)
    return jreads.pad_batch(b, n_reads)


@functools.lru_cache(maxsize=None)
def _jmesh(shape):
    if len(shape) == 2:
        return jtl.two_level_mesh(shape[0])
    return jtl.two_level_mesh3(*shape)


def _tmesh(shape):
    return tmesh_lib.make_mesh(devices=["cpu"], shape=shape)


def _jax_count(b, shape, **kw):
    return jtl.sharded_count_two_level(jnp.asarray(b.codes), jnp.asarray(b.lengths),
                                       jnp.asarray(b.read_ids), mesh=_jmesh(shape), **kw)


def assert_rows_equal(a, b):
    """Two port counts, every field of every shard, row for row."""
    for name in tsc.ShardedCount._fields:
        for x, y in zip(getattr(a, name), getattr(b, name)):
            assert torch.equal(x, y), name


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("parity", [False, True])
def test_two_level_count_matches_jax_and_the_flat_router(shape, parity):
    assert jax.device_count() == 8
    b = _batch()
    kw = dict(k=11, m=5, parity=parity, cutoff=1)
    want = _jax_count(b, shape, **kw)
    tm = _tmesh(shape)
    got = ttl.sharded_count_two_level(b.codes, b.lengths, b.read_ids, mesh=tm, **kw)
    assert_same_count(want, got)
    assert tm.total(got.overflow) == 0
    flat = tsc.sharded_count(b.codes, b.lengths, b.read_ids, mesh=tmesh_lib.make_mesh(
        8, devices=["cpu"]), **kw)
    assert_rows_equal(got, flat)
    # the routing switch dispatches to it
    assert_rows_equal(tsc.sharded_count(b.codes, b.lengths, b.read_ids, mesh=tm,
                                        routing="two_level", **kw), got)


def test_replay_groups_equal_the_flat_router():
    b = _batch(seed=5)
    kw = dict(k=7, m=3, parity=True, cutoff=-1)
    tm = _tmesh((2, 4))
    got = ttl.sharded_count_two_level(b.codes, b.lengths, b.read_ids, mesh=tm, **kw)
    flat_mesh = tmesh_lib.make_mesh(8, devices=["cpu"])
    flat = tsc.sharded_count(b.codes, b.lengths, b.read_ids, mesh=flat_mesh, **kw)
    for x, y in zip(tsc.sharded_groups_for_replay(got, tm),
                    tsc.sharded_groups_for_replay(flat, flat_mesh)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("shape", [(2, 4), (2, 2, 2)])
def test_small_slack_overflows_as_jax_counts(shape):
    """All reads alike: one hot owner.  A tiny slack drops records in both
    stages; the counters say so, shard for shard as JAX's (the same float
    capacities, the same slots)."""
    reads = ["A" * 40] * 32 + ["ACGTTGCA" * 5] * 32
    (b,) = jreads.batch_reads(reads, 48)
    kw = dict(k=11, m=5, parity=False, cutoff=1, slack=0.05)
    want = _jax_count(b, shape, **kw)
    got = ttl.sharded_count_two_level(b.codes, b.lengths, b.read_ids, mesh=_tmesh(shape), **kw)
    assert np.asarray(want.overflow).sum() > 0
    np.testing.assert_array_equal([int(x) for x in got.overflow], np.asarray(want.overflow))
    assert_same_count(want, got)


def test_stage_walls_are_recorded():
    b = _batch()
    walls = {}
    ttl.sharded_count_two_level(b.codes, b.lengths, b.read_ids, k=11, m=5, parity=False,
                                cutoff=1, mesh=_tmesh((2, 4)), walls=walls)
    assert set(walls) == {"scan_and_stage", "exchange_ici", "restage", "exchange_slices",
                          "count"}
    assert all(v >= 0 for v in walls.values())


def test_refusals():
    b = _batch()
    kw = dict(k=11, m=5, cutoff=1)
    with pytest.raises(ValueError, match="minimizer only"):
        tsc.sharded_count(b.codes, b.lengths, b.read_ids, parity=False, routing="two_level",
                          route_by="key", mesh=_tmesh((2, 4)), **kw)
    with pytest.raises(ValueError, match="slices"):
        ttl.sharded_count_two_level(b.codes, b.lengths, b.read_ids, parity=False,
                                    mesh=tmesh_lib.make_mesh(8, devices=["cpu"]), **kw)
    with pytest.raises(ValueError, match="unknown routing"):
        tsc.sharded_count_batches([b], parity=False, routing="two_level",
                                  mesh=_tmesh((2, 4)), **kw)
    with pytest.raises(ValueError, match="odd k"):
        tm = _tmesh((2, 4))
        ttl.partitioned_unitig_links_join_two_level(*_sharded_keys(tm, *_keys(11, 11)), k=12,
                                                    mesh=tm)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", [11, 31])
def test_links_join_matches_jax_and_the_flat_join(shape, k):
    hi, lo, valid = _keys(k, k)
    want, jovf = jtl.partitioned_unitig_links_join_two_level(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), k=k, mesh=_jmesh(shape))
    assert int(np.sum(np.asarray(jovf))) == 0
    tm = _tmesh(shape)
    got, ovf = ttl.partitioned_unitig_links_join_two_level(*_sharded_keys(tm, hi, lo, valid),
                                                           k=k, mesh=tm)
    assert tm.total(ovf) == 0
    np.testing.assert_array_equal(_whole(tm, got), np.asarray(want))
    flat_mesh = tmesh_lib.make_mesh(8, devices=["cpu"])
    flat, _ = tpart.partitioned_unitig_links_join(*_sharded_keys(flat_mesh, hi, lo, valid),
                                                  k=k, mesh=flat_mesh)
    np.testing.assert_array_equal(_whole(tm, got), _whole(flat_mesh, flat))


def test_links_join_overflow_is_counted_as_jax_counts_it():
    hi, lo, valid = _keys(11, 5, size=700)
    _, jovf = jtl.partitioned_unitig_links_join_two_level(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), k=11, mesh=_jmesh((2, 4)),
        slack=0.02)
    tm = _tmesh((2, 4))
    _, ovf = ttl.partitioned_unitig_links_join_two_level(*_sharded_keys(tm, hi, lo, valid),
                                                         k=11, mesh=tm, slack=0.02)
    assert np.asarray(jovf).sum() > 0
    np.testing.assert_array_equal([int(x) for x in ovf], np.asarray(jovf))


def test_meshes_and_axis_exchanges():
    tm = ttl.two_level_mesh(2, devices=["cpu"], n_shards=8)
    assert tm.shape == (2, 4) and tm.axis_names == ("slices", "shards")
    t3 = ttl.two_level_mesh3(2, 2, 2, devices=["cpu"])
    assert t3.shape == (2, 2, 2) and t3.axis_names == ("slices", "x", "y")
    assert t3.members(5, ("x", "y")) == [4, 5, 6, 7] and t3.members(5, "slices") == [1, 5]
    # block j of every shard goes to the j-th shard of its group
    blocks = [torch.arange(4 * 3).reshape(4, 3) + 100 * i for i in range(8)]
    got = t3.all_to_all(blocks, ("x", "y"))
    for j in range(8):
        for i, src in enumerate(t3.members(j, ("x", "y"))):
            assert torch.equal(got[j][i], blocks[src][t3.members(j, ("x", "y")).index(j)])
    with pytest.raises(ValueError):
        ttl.two_level_mesh(3, devices=["cpu"], n_shards=8)
    with pytest.raises(RuntimeError):
        if not torch.cuda.is_available():
            ttl.two_level_mesh(2)

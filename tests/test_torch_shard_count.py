"""Port vs JAX package: the sharded count on meshes of 4 and 8 CPU shards.

The same numpy-seeded batches go through the JAX ``shard_count`` (on the
conftest's 8 virtual devices) and the port's (a one-process mesh of CPU
shards); results are compared through ``convert.sharded_count_to_lanes``
at tolerance 0: every row's validity, group start, count and keep flag,
and the lanes of every row that holds a record (the rows without one
differ in their filler by design).  Also the mesh's collectives and the
ownership hashes.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_assembly_tpu.io import datagen
from genome_assembly_tpu.io import reads as jreads
from genome_assembly_tpu.parallel import mesh as jmesh_lib
from genome_assembly_tpu.parallel import shard_count as jsc
from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.parallel import mesh as tmesh_lib
from genome_assembly_tpu_torch.parallel import ragged
from genome_assembly_tpu_torch.parallel import shard_count as tsc

SHARDS = [4, 8]
FIELDS = ("mmer", "kmer_hi", "kmer_lo", "read_id", "stream_idx", "valid", "group_start",
          "count", "keep", "overflow")


@functools.lru_cache(maxsize=None)
def _meshes(n):
    return jmesh_lib.make_mesh(n), tmesh_lib.make_mesh(n, devices=["cpu"])


def _batch(reads, max_len, n):
    (b,) = jreads.batch_reads(reads, max_len)
    return jreads.pad_batch(b, n * -(-len(reads) // n))


@functools.lru_cache(maxsize=None)
def _reads(parity, genome_len=800, seed=2):
    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=genome_len, read_len=48, coverage=6, seed=seed, with_reverse=not parity)
    return tuple(reads)


def assert_same_count(j, t):
    want = [np.asarray(x) for x in j]
    got = convert.sharded_count_to_lanes(t)
    valid = want[FIELDS.index("valid")]
    for name, a, b in zip(FIELDS, want, got):
        assert a.shape == b.shape, name
        if name in ("valid", "group_start", "count", "keep", "overflow"):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_array_equal(b[valid], a[valid], err_msg=name)


def _both(n, reads, max_len=64, **kw):
    jm, tm = _meshes(n)
    b = _batch(list(reads), max_len, n)
    j = jsc.sharded_count(jnp.asarray(b.codes), jnp.asarray(b.lengths),
                          jnp.asarray(b.read_ids), mesh=jm, **kw)
    t = tsc.sharded_count(b.codes, b.lengths, b.read_ids, mesh=tm, **kw)
    return j, t, tm


# -- ownership -------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 4, 7, 8])
def test_owner_of_matches_jax(n):
    rng = np.random.default_rng(n)
    mmer = rng.integers(0, 1 << 30, size=5000).astype(np.uint32)
    want = np.asarray(jsc.owner_of(jnp.asarray(mmer), n))
    got = tsc.owner_of(torch.from_numpy(mmer.astype(np.int32)), n).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 3, 4, 7, 8])
def test_key_owner_of_matches_jax(n):
    rng = np.random.default_rng(10 + n)
    key = rng.integers(0, 1 << 62, size=5000, dtype=np.int64)
    hi, lo = convert.key_to_lanes(key)
    want = np.asarray(jsc.key_owner_of(jnp.asarray(hi), jnp.asarray(lo), n))
    np.testing.assert_array_equal(tsc.key_owner_of(torch.from_numpy(key), n).numpy(), want)


# -- the count ---------------------------------------------------------------


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("parity,routing,route_by", [
    (False, "padded", "mmer"), (False, "padded", "key"), (False, "ragged", "mmer"),
    (False, "ragged", "key"), (True, "padded", "mmer"), (True, "ragged", "mmer"),
])
def test_sharded_count_matches_jax(n, parity, routing, route_by):
    j, t, tm = _both(n, _reads(parity), k=11, m=5, parity=parity, cutoff=1,
                     routing=routing, route_by=route_by)
    assert_same_count(j, t)
    assert tm.total(t.overflow) == 0
    assert tsc.sharded_to_host_dict(t, 11, 5, tm) == jsc.sharded_to_host_dict(j, 11, 5)


def test_sharded_count_parity_keeps_every_group_with_cutoff_minus_one():
    j, t, tm = _both(8, _reads(True), k=11, m=5, parity=True, cutoff=-1)
    assert_same_count(j, t)
    assert all(bool(torch.equal(k, g & v)) for k, g, v in zip(t.keep, t.group_start, t.valid))


@pytest.mark.parametrize("routing", ["padded", "ragged"])
def test_overflow_is_counted_as_jax_counts_it(routing):
    """All reads alike: one hot owner.  A tiny slack drops records and the
    counters say so, shard for shard as JAX's (the same float caps)."""
    reads = ("A" * 48,) * 64
    j, t, tm = _both(8, reads, k=11, m=5, parity=False, cutoff=1, slack=0.05, routing=routing)
    want = np.asarray(j.overflow)
    assert want.sum() > 0
    np.testing.assert_array_equal([int(x) for x in t.overflow], want)
    assert_same_count(j, t)


@pytest.mark.parametrize("n_local,n_shards,slack,routing", [
    (1700, 8, 4.0, "padded"), (1700, 8, 4.0, "ragged"), (1701, 3, 0.05, "padded"),
    (5, 8, 0.05, "ragged"), (98 * 578, 4, 4.0, "padded")])
def test_routing_cap_matches_jax(n_local, n_shards, slack, routing):
    assert tsc._routing_cap(n_local, n_shards, slack, routing) == jsc._routing_cap(
        n_local, n_shards, slack, routing)


def test_refusals():
    b = _batch(["ACGTACGTACGTACGT"] * 8, 32, 8)
    _, tm = _meshes(8)
    kw = dict(k=11, m=5, cutoff=1, mesh=tm)
    with pytest.raises(ValueError, match="parity"):
        tsc.sharded_count(b.codes, b.lengths, b.read_ids, parity=True, route_by="key", **kw)
    with pytest.raises(ValueError, match="unknown routing"):
        tsc.sharded_count(b.codes, b.lengths, b.read_ids, parity=False, routing="flat", **kw)
    with pytest.raises(NotImplementedError, match="second multi-device slice"):
        tsc.sharded_count(b.codes, b.lengths, b.read_ids, parity=False, routing="two_level",
                          **kw)
    with pytest.raises(NotImplementedError, match="second multi-device slice"):
        tsc.sharded_count_batches([b], parity=False, checkpoint_dir="ckpt", **kw)
    with pytest.raises(ValueError, match="divide"):
        tsc.sharded_count(b.codes[:6], b.lengths[:6], b.read_ids[:6], parity=False, **kw)


# -- many batches ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _batches(rows=24, seed=9, parity=False):
    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=900, read_len=48, coverage=6, seed=seed, with_reverse=not parity)
    return tuple(jreads.pad_batch(b, rows) for b in jreads.batch_reads(reads, 64, rows))


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("parity,routing,route_by", [
    (False, "padded", "mmer"), (False, "ragged", "key"), (True, "ragged", "mmer")])
def test_batches_match_jax_and_pipelined_equals_unpipelined(n, parity, routing, route_by):
    """The port routes each batch as it comes (one loop order); it equals
    both of the JAX package's orders, which equal each other."""
    batches = _batches(parity=parity)
    assert len(batches) >= 3
    jm, tm = _meshes(n)
    kw = dict(k=11, m=5, parity=parity, cutoff=1, routing=routing, route_by=route_by)
    got = tsc.sharded_count_batches(list(batches), mesh=tm, **kw)
    for p in (False, True):
        assert_same_count(jsc.sharded_count_batches(list(batches), mesh=jm, pipelined=p, **kw),
                          got)


def test_batches_equal_one_batch_of_the_same_reads():
    """Groups spanning batches are whole: the kept table of three batches
    equals that of one batch holding all their reads."""
    _, tm = _meshes(8)
    batches = _batches()
    kw = dict(k=11, m=5, parity=False, cutoff=1, mesh=tm)
    many = tsc.sharded_count_batches(list(batches), **kw)
    whole = jreads.ReadBatch(np.concatenate([b.codes for b in batches]),
                             np.concatenate([b.lengths for b in batches]),
                             np.concatenate([b.read_ids for b in batches]))
    one = tsc.sharded_count(whole.codes, whole.lengths, whole.read_ids, **kw)
    assert tsc.sharded_to_host_dict(many, 11, 5, tm) == tsc.sharded_to_host_dict(one, 11, 5, tm)


# -- host views ------------------------------------------------------------


@pytest.mark.parametrize("routing", ["padded", "ragged"])
def test_replay_groups_and_host_table_match_jax(routing):
    batches = _batches(parity=True, seed=21)
    jm, tm = _meshes(8)
    kw = dict(k=11, m=5, parity=True, cutoff=-1, routing=routing)
    j = jsc.sharded_count_batches(list(batches), mesh=jm, **kw)
    t = tsc.sharded_count_batches(list(batches), mesh=tm, **kw)
    mmer, hi, lo, offsets, ids = jsc.sharded_groups_for_replay(j)
    got = tsc.sharded_groups_for_replay(t, tm)
    for a, b in zip(got, (mmer, convert.lanes_to_key(hi, lo), offsets, ids)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.asarray(b).dtype
    jhost, jstreams = jsc.sharded_host_table_with_streams(j)
    thost, tstreams = tsc.sharded_host_table_with_streams(t, tm)
    for a, b in zip(convert.host_table_to_lanes(thost), jhost):
        if isinstance(b, list):
            assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            np.testing.assert_array_equal(a, b)
    assert len(tstreams) == len(jstreams)
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(tstreams, jstreams))


def test_convert_round_trip_of_a_jax_count():
    j, _, tm = _both(4, _reads(False), k=11, m=5, parity=False, cutoff=1, route_by="key")
    back = convert.sharded_count_from_lanes(*[np.asarray(x) for x in j])
    assert_same_count(j, back)
    assert tsc.sharded_to_host_dict(back, 11, 5, tm) == jsc.sharded_to_host_dict(j, 11, 5)


# -- the mesh ----------------------------------------------------------------


def test_make_mesh_places_shards():
    m = tmesh_lib.make_mesh(8, devices=["cpu"])
    assert m.n_shards == 8 and m.local == tuple(range(8)) and m.group is None
    assert set(m.devices) == {torch.device("cpu")}
    assert tmesh_lib.make_mesh(devices="cpu").n_shards == 1
    with pytest.raises(ValueError):
        tmesh_lib.make_mesh(0, devices=["cpu"])


@pytest.mark.parametrize("n", SHARDS)
def test_all_to_all_sends_block_j_to_shard_j(n):
    _, tm = _meshes(n)
    blocks = [torch.arange(n * 3).reshape(n, 3) + 100 * i for i in range(n)]
    got = tm.all_to_all(blocks)
    for j, g in enumerate(got):
        for i in range(n):
            assert torch.equal(g[i], blocks[i][j])


@pytest.mark.parametrize("n", SHARDS)
def test_ragged_exchange_and_gather(n):
    _, tm = _meshes(n)
    rng = np.random.default_rng(n)
    sizes = rng.integers(0, 5, size=(n, n))
    rows = [torch.arange(int(sizes[i].sum())) + 1000 * i for i in range(n)]
    got = tm.all_to_all_ragged(rows, sizes.tolist())
    for j, g in enumerate(got):
        want = [rows[i][int(sizes[i, :j].sum()):int(sizes[i, :j + 1].sum())] for i in range(n)]
        assert torch.equal(g, torch.cat(want))
    gathered = tm.all_gather([torch.tensor([i, -i]) for i in range(n)])
    assert all(g is gathered[0] for g in gathered)
    assert gathered[0].tolist() == [v for i in range(n) for v in (i, -i)]
    assert tm.total([torch.tensor(i) for i in range(n)]) == n * (n - 1) // 2
    assert tm.to_host([torch.tensor([i]) for i in range(n)]).shape == (n, 1)


def test_route_records_ragged_clamps_to_the_budget():
    """Greedy grants by sender rank: once a receiver's budget is spent,
    later senders' records are dropped and counted, nothing is written out
    of bounds."""
    n, cap = 4, 5
    _, tm = _meshes(n)
    owner = [torch.tensor([0, 0, 0, 1, 4]), torch.tensor([0, 0, 0, 2, 2]),
             torch.tensor([0, 3, 4, 4, 4]), torch.tensor([1, 1, 1, 1, 1])]
    payload = [torch.stack([torch.arange(5) + 10 * i, -torch.arange(5)], 1) for i in range(n)]
    received, dropped = ragged.route_records_ragged(owner, payload, n_shards=n,
                                                   cap_total=cap, mesh=tm)
    assert [int(d) for d in dropped] == [0, 1, 1, 1]
    assert received[0][:, 0].tolist() == [0, 1, 2, 10, 11]
    assert received[1][:, 0].tolist()[:5] == [3, 30, 31, 32, 33]
    assert received[2][:2, 0].tolist() == [13, 14] and received[3][0, 0] == 21
    assert all(r.shape == (cap, 2) for r in received)

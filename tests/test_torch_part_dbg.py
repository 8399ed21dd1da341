"""Port vs JAX package: the routed link join and the sharded jumps.

The same numpy-seeded key tables and successor arrays go through the JAX
``part_dbg`` / ``shard_dbg`` functions (conftest's 8 virtual devices) and
the port's on one-process meshes of 4 and 8 CPU shards, compared as int64
arrays.  The port's state ids are int64, so it has no wide forms: JAX's
wide (owner, local) ids and (hi, lo) rank lanes are joined into global ids
and 64-bit ranks and held against the port's narrow join and jump.
Tolerance 0, and every overflow counter zero.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_assembly_tpu.ops import dbg as jdbg
from genome_assembly_tpu.ops import encode as jencode
from genome_assembly_tpu.parallel import mesh as jmesh_lib
from genome_assembly_tpu.parallel import part_dbg as jpart
from genome_assembly_tpu.parallel import shard_dbg as jshard
from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.ops import dbg as tdbg
from genome_assembly_tpu_torch.parallel import mesh as tmesh_lib
from genome_assembly_tpu_torch.parallel import part_dbg as tpart
from genome_assembly_tpu_torch.parallel import shard_dbg as tshard

SHARDS = [4, 8]
GRAPH_FIELDS = ("head", "rank", "is_cycle")


@functools.lru_cache(maxsize=None)
def _meshes(n):
    return jmesh_lib.make_mesh(n), tmesh_lib.make_mesh(n, devices=["cpu"])


@functools.lru_cache(maxsize=None)
def _keys(k, seed, size=600, pad=1024):
    """The padded sorted canonical keys of a random genome, as the JAX
    tests of tests/test_sharding.py build them: (hi, lo, valid) lanes."""
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=size))
    rc = str.maketrans("ACGT", "TGCA")
    keys = sorted({min(jencode.pack_str(genome[i:i + k]),
                       jencode.pack_str(genome[i:i + k].translate(rc)[::-1]))
                   for i in range(len(genome) - k + 1)})
    n_lo = min(k, 16)
    hi = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    lo = np.full(pad, 0xFFFFFFFF, dtype=np.uint32)
    valid = np.zeros(pad, dtype=bool)
    for i, v in enumerate(keys):
        hi[i], lo[i], valid[i] = v >> (2 * n_lo), v & ((1 << (2 * n_lo)) - 1), True
    return hi, lo, valid


def _sharded_keys(tm, hi, lo, valid):
    kmer, v = convert.padded_keys_from_lanes(hi, lo, valid)
    return tm.shard_rows(kmer), tm.shard_rows(v)


def _whole(tm, xs):
    return tm.to_host(xs).reshape(-1)


def _zero(tm, overflow):
    return tm.total(overflow) == 0


def _global_ids(owner, local, rows2):
    """JAX's wide (owner, local) state ids -> global int64 ids (-1 stays)."""
    owner, local = np.asarray(owner).astype(np.int64), np.asarray(local).astype(np.int64)
    return np.where(owner >= 0, owner * rows2 + local, -1)


def _rank64(hi, lo):
    """JAX's wide rank lanes -> one int64."""
    return (np.asarray(hi).astype(np.int64) << 32) | np.asarray(lo).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _jax_links(n, k, seed):
    jm, _ = _meshes(n)
    hi, lo, valid = _keys(k, seed)
    links, ovf = jpart.partitioned_unitig_links_join(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), k=k, mesh=jm)
    assert int(np.sum(np.asarray(ovf))) == 0
    return np.asarray(links)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("k", [5, 11, 17, 31])
def test_links_join_matches_jax_and_the_single_device_join(n, k):
    _, tm = _meshes(n)
    hi, lo, valid = _keys(k, k)
    kmer, v = _sharded_keys(tm, hi, lo, valid)
    got, ovf = tpart.partitioned_unitig_links_join(kmer, v, k=k, mesh=tm)
    assert _zero(tm, ovf)
    want = _jax_links(n, k, k)
    np.testing.assert_array_equal(_whole(tm, got), want)
    one = tdbg.build_unitig_links_join(*convert.padded_keys_from_lanes(hi, lo, valid), k=k)
    np.testing.assert_array_equal(one.numpy(), want)


def test_links_join_refuses_even_k():
    _, tm = _meshes(4)
    kmer, v = _sharded_keys(tm, *_keys(11, 11))
    with pytest.raises(ValueError, match="odd k"):
        tpart.partitioned_unitig_links_join(kmer, v, k=12, mesh=tm)


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("k", [5, 31])
def test_wide_links_join_matches_jax(n, k):
    jm, tm = _meshes(n)
    hi, lo, valid = _keys(k, 100 + k, size=700)
    no, nl, ovf = jpart.partitioned_unitig_links_join_wide(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid), k=k, mesh=jm)
    assert int(np.sum(np.asarray(ovf))) == 0
    kmer, v = _sharded_keys(tm, hi, lo, valid)
    got, tovf = tpart.partitioned_unitig_links_join(kmer, v, k=k, mesh=tm)
    assert _zero(tm, tovf)
    np.testing.assert_array_equal(_whole(tm, got), _global_ids(no, nl, 2 * len(hi) // n))


def _successors(seed, n2=512):
    """Random partial permutations (in-degree <= 1 by construction):
    cycles inside the kept subset stay cycles, the rest break into chains."""
    rng = np.random.default_rng(seed)
    sigma = rng.permutation(n2)
    keep = rng.random(n2) < rng.uniform(0.3, 0.9)
    return np.where(keep, sigma, -1).astype(np.int32)


def _chains_and_a_cycle(n2=512):
    """A chain crossing every shard, a cycle over two shards, short pairs."""
    nxt = np.full(n2, -1, dtype=np.int32)
    chain = np.arange(0, n2, 9)
    nxt[chain[:-1]] = chain[1:]
    cyc = np.arange(100, 116)
    cyc = cyc[~np.isin(cyc, chain)]
    nxt[cyc] = np.roll(cyc, -1)
    for a in range(480, 500, 2):
        if nxt[a] < 0 and a + 1 not in chain:
            nxt[a] = a + 1
    return nxt


def _cases():
    return [("chains", _chains_and_a_cycle())] + [(f"fuzz{s}", _successors(s)) for s in range(5)]


@pytest.mark.parametrize("n", SHARDS)
def test_jumps_match_jax_on_links_of_real_keys(n):
    jm, tm = _meshes(n)
    links = _jax_links(n, 11, 11)
    want = jshard.sharded_pointer_jump(jnp.asarray(links), mesh=jm)
    want_p, jovf = jpart.partitioned_pointer_jump(jnp.asarray(links), mesh=jm)
    assert int(np.sum(np.asarray(jovf))) == 0
    nxt = tm.shard_rows(torch.from_numpy(links.astype(np.int64)))
    got = tshard.sharded_pointer_jump(nxt, mesh=tm)
    got_p, ovf = tpart.partitioned_pointer_jump(nxt, mesh=tm)
    assert _zero(tm, ovf)
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(_whole(tm, getattr(got, f)), np.asarray(getattr(want, f)))
        np.testing.assert_array_equal(_whole(tm, getattr(got_p, f)),
                                      np.asarray(getattr(want_p, f)))


@pytest.mark.parametrize("n", SHARDS)
def test_jumps_match_the_single_device_jump(n):
    """Both sharded jumps == ``dbg.pointer_jump`` of JAX and of the port on
    long chains, a cycle, pairs and random partial permutations."""
    _, tm = _meshes(n)
    for name, nxt in _cases():
        want = jdbg.pointer_jump(jnp.asarray(nxt))
        one = tdbg.pointer_jump(torch.from_numpy(nxt.astype(np.int64)))
        sharded = tm.shard_rows(torch.from_numpy(nxt.astype(np.int64)))
        got_s = tshard.sharded_pointer_jump(sharded, mesh=tm)
        got_p, ovf = tpart.partitioned_pointer_jump(sharded, mesh=tm)
        assert _zero(tm, ovf), name
        for f in GRAPH_FIELDS:
            w = np.asarray(getattr(want, f))
            np.testing.assert_array_equal(getattr(one, f).numpy(), w, err_msg=name)
            np.testing.assert_array_equal(_whole(tm, getattr(got_s, f)), w, err_msg=name)
            np.testing.assert_array_equal(_whole(tm, getattr(got_p, f)), w, err_msg=name)


@pytest.mark.parametrize("n", SHARDS)
def test_wide_jump_matches_jax(n):
    jm, tm = _meshes(n)
    for name, nxt in _cases():
        rows2 = nxt.shape[0] // n
        no = np.where(nxt >= 0, nxt // rows2, -1).astype(np.int32)
        nl = np.where(nxt >= 0, nxt % rows2, -1).astype(np.int32)
        want, jovf = jpart.partitioned_pointer_jump_wide(jnp.asarray(no), jnp.asarray(nl),
                                                         mesh=jm)
        assert int(np.sum(np.asarray(jovf))) == 0
        got, ovf = tpart.partitioned_pointer_jump(
            tm.shard_rows(torch.from_numpy(_global_ids(no, nl, rows2))), mesh=tm)
        assert _zero(tm, ovf), name
        for f, w in [("next_state", _global_ids(want.next_owner, want.next_local, rows2)),
                     ("head", _global_ids(want.head_owner, want.head_local, rows2)),
                     ("rank", _rank64(want.rank_hi, want.rank_lo)),
                     ("is_cycle", np.asarray(want.is_cycle))]:
            np.testing.assert_array_equal(_whole(tm, getattr(got, f)), w, err_msg=f"{name} {f}")


def test_wide_rank_lanes_carry_as_jax_adds():
    """The port's rank is one int64: JAX's two-lane ``_add64`` carry past
    2**32, joined as the wide tests join it, equals the int64 sum; and the
    wide ids join back to global ids."""
    a_hi = np.array([0, 0, 7, 1, 0], dtype=np.uint32)
    a_lo = np.array([0xFFFFFFFF, 0xFFFFFFFE, 0xFFFFFFFF, 5, 0], dtype=np.uint32)
    b_hi = np.array([0, 0, 0, 2, 0], dtype=np.uint32)
    b_lo = np.array([1, 1, 0xFFFFFFFF, 0xFFFFFFFF, 0], dtype=np.uint32)
    want_hi, want_lo = jax.jit(jpart._add64)(a_hi, a_lo, b_hi, b_lo)
    got = torch.from_numpy(_rank64(a_hi, a_lo)) + torch.from_numpy(_rank64(b_hi, b_lo))
    np.testing.assert_array_equal(got.numpy(), _rank64(want_hi, want_lo))
    owner = np.array([-1, 0, 0, 1, 15], dtype=np.int32)
    local = np.array([-1, 0, 63, 0, 40], dtype=np.int32)
    assert _global_ids(owner, local, 64).tolist() == [-1, 0, 63, 64, 1000]


def test_pack_by_owner_places_records_as_jax_does():
    """Block j holds the first ``cap`` active records owned by shard j, in
    order, fills elsewhere; records past the capacity are counted."""
    rng = np.random.default_rng(7)
    q, n_shards, cap = 4096, 8, 40
    owner = rng.integers(0, n_shards, size=q).astype(np.int32)
    active = rng.random(q) < 0.8
    pay_a = rng.integers(0, 2**31, size=q).astype(np.uint32)
    pay_b = rng.integers(0, 2**31, size=q).astype(np.int32)
    blocks, _, jovf = jax.jit(jpart._pack_by_owner, static_argnums=(4, 5))(
        jnp.asarray(owner), jnp.asarray(active), (jnp.asarray(pay_a), jnp.asarray(pay_b)),
        (np.uint32(0xFFFFFFFF), np.int32(-1)), n_shards, cap)
    got, ovf = tpart._pack_by_owner(
        torch.from_numpy(owner.astype(np.int64)), torch.from_numpy(active),
        (torch.from_numpy(pay_a.astype(np.int64)), torch.from_numpy(pay_b.astype(np.int64))),
        (0xFFFFFFFF, -1), n_shards, cap)
    assert int(ovf) == int(jovf) > 0
    np.testing.assert_array_equal(got[:, :, 0].numpy().astype(np.uint32), np.asarray(blocks[0]))
    np.testing.assert_array_equal(got[:, :, 1].numpy().astype(np.int32), np.asarray(blocks[1]))


def test_jump_overflow_is_counted():
    """One chain through every state: with a tiny slack the routed gather's
    requests do not fit, and the counters say so."""
    _, tm = _meshes(4)
    n2 = 256
    nxt = torch.arange(1, n2 + 1)
    nxt[-1] = -1
    _, ovf = tpart.partitioned_pointer_jump(tm.shard_rows(nxt), mesh=tm, slack=0.01)
    assert tm.total(ovf) > 0

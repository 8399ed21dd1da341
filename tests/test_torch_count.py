"""Port vs JAX package: sort-based counting and pruning, and the hashes (CPU).

Random window records with duplicates and invalid slots, made from a seed
with numpy, go through ``ops/count`` of both packages; every field is
compared after ``convert`` maps lanes <-> int64 keys.  Integers only:
tolerance 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genome_assembly_tpu import common as jcommon
from genome_assembly_tpu.ops import count as jcount
from genome_assembly_tpu.ops.minimizer import WindowRecords as JRecords
from genome_assembly_tpu_torch import common as tcommon
from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.ops import bitonic_sort
from genome_assembly_tpu_torch.ops import count as tcount

K = 31


def _records(seed, shape=(6, 50), n_distinct=40, p_valid=0.8):
    """The same records in both conventions: keys drawn from a small pool so
    runs of every length occur, some slots invalid."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << (2 * K), size=n_distinct, dtype=np.int64)
    key = pool[rng.integers(0, n_distinct, size=shape)]
    valid = rng.random(shape) < p_valid
    hi, lo = convert.key_to_lanes(key)
    mmer = rng.integers(0, 1 << 14, size=shape).astype(np.uint32)
    jrecs = JRecords(jnp.asarray(mmer), jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid))
    trecs = convert.window_records_from_lanes(mmer, hi, lo, valid)
    return jrecs, trecs


def _assert_key_counts(jkc, tkc):
    hi, lo, valid, group_start, keep = convert.key_counts_to_lanes(tkc)
    assert np.array_equal(hi, np.asarray(jkc.kmer_hi))
    assert np.array_equal(lo, np.asarray(jkc.kmer_lo))
    assert np.array_equal(valid, np.asarray(jkc.valid))
    assert np.array_equal(group_start, np.asarray(jkc.group_start))
    assert np.array_equal(keep, np.asarray(jkc.keep))


@pytest.mark.parametrize("cutoff", [0, 1, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_count_keys_matches_jax(cutoff, seed):
    jrecs, trecs = _records(seed)
    jkc = jcount.count_keys(jrecs, cutoff=cutoff)
    tkc = tcount.count_keys(trecs, cutoff=cutoff)
    _assert_key_counts(jkc, tkc)
    assert np.array_equal(
        tcount.key_group_counts(tkc).numpy(), np.asarray(jcount.key_group_counts(jkc)))


@pytest.fixture
def small_network(monkeypatch):
    """Shrink the sort's default chunks so that a few hundred keys run the
    bitonic network; returns the list of network passes that were called."""
    monkeypatch.setattr(bitonic_sort, "DEFAULT_LIB_CHUNK", 16)
    monkeypatch.setattr(bitonic_sort, "DEFAULT_CHUNK", 4)
    calls = []
    for name in ("big_ce_plain", "finish_plain"):
        real = getattr(bitonic_sort, name)
        monkeypatch.setattr(
            bitonic_sort, name,
            lambda *a, _real=real, _name=name, **kw: (calls.append(_name), _real(*a, **kw))[1])
    return calls


@pytest.mark.parametrize("cutoff", [0, 1, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_count_keys_hybrid_sort_matches_default_and_jax(small_network, cutoff, seed):
    jrecs, trecs = _records(seed)
    plain = tcount.count_keys(trecs, cutoff=cutoff)
    assert small_network == []  # the default route runs no network pass
    hybrid = tcount.count_keys(trecs, cutoff=cutoff, hybrid_sort=True)
    # 300 keys pad to 512 = 16 * 2^5: five merge levels, one finish each
    assert small_network.count("finish_plain") == 5
    assert small_network.count("big_ce_plain") == 3 + 4 + 5 + 6 + 7
    for f in plain._fields:
        assert torch.equal(getattr(hybrid, f), getattr(plain, f)), f
    _assert_key_counts(jcount.count_keys(jrecs, cutoff=cutoff), hybrid)
    _assert_key_counts(jcount.count_keys(jrecs, cutoff=cutoff, pallas_sort=True), hybrid)


@pytest.mark.parametrize("p_valid", [1.0, 0.0])
def test_count_keys_hybrid_sort_all_or_nothing_valid(small_network, p_valid):
    jrecs, trecs = _records(7, p_valid=p_valid)
    hybrid = tcount.count_keys(trecs, cutoff=1, hybrid_sort=True)
    assert small_network
    _assert_key_counts(jcount.count_keys(jrecs, cutoff=1), hybrid)


def test_count_keys_hybrid_sort_below_threshold_is_the_library_sort(small_network):
    jrecs, trecs = _records(8, shape=(2, 16))  # 32 keys = two library chunks
    hybrid = tcount.count_keys(trecs, cutoff=1, hybrid_sort=True)
    assert small_network == []
    _assert_key_counts(jcount.count_keys(jrecs, cutoff=1), hybrid)


@pytest.mark.parametrize("p_valid", [1.0, 0.0])
def test_count_keys_all_or_nothing_valid(p_valid):
    jrecs, trecs = _records(7, p_valid=p_valid)
    _assert_key_counts(jcount.count_keys(jrecs, cutoff=1), tcount.count_keys(trecs, cutoff=1))


@pytest.mark.parametrize("cutoff", [0, 1, 3])
def test_kept_keys_sorted_matches_jax(cutoff):
    jrecs, trecs = _records(2)
    jkc = jcount.count_keys(jrecs, cutoff=cutoff)
    tkc = tcount.count_keys(trecs, cutoff=cutoff)
    jhi, jlo, jvalid = (np.asarray(x) for x in jcount.kept_keys_sorted(jkc))
    hi, lo, valid = convert.padded_keys_to_lanes(*tcount.kept_keys_sorted(tkc))
    assert hi.shape == jhi.shape  # padded to the input length, sentinel tail
    assert np.array_equal(hi, jhi) and np.array_equal(lo, jlo)
    assert np.array_equal(valid, jvalid)
    # a JAX KeyCounts carried across compacts to the same table
    carried = convert.key_counts_from_lanes(*(np.asarray(x) for x in jkc))
    assert all(torch.equal(a, b) for a, b in zip(carried, tkc))
    assert all(torch.equal(a, b) for a, b in zip(
        tcount.kept_keys_sorted(carried), tcount.kept_keys_sorted(tkc)))
    # and the other way: JAX's triple becomes the port's pair
    kmer, v = convert.padded_keys_from_lanes(jhi, jlo, jvalid)
    tk, tv = tcount.kept_keys_sorted(tkc)
    assert torch.equal(kmer, tk) and torch.equal(v, tv)


@pytest.mark.parametrize("cutoff", [0, 1, 3])
def test_kept_keys_sorted_with_counts_matches_jax(cutoff):
    jrecs, trecs = _records(3)
    jkc = jcount.count_keys(jrecs, cutoff=cutoff)
    tkc = tcount.count_keys(trecs, cutoff=cutoff)
    jhi, jlo, jvalid, jcnt = (np.asarray(x) for x in jcount.kept_keys_sorted_with_counts(jkc))
    kmer, valid, cnt = tcount.kept_keys_sorted_with_counts(tkc)
    hi, lo, valid = convert.padded_keys_to_lanes(kmer, valid)
    assert np.array_equal(hi, jhi) and np.array_equal(lo, jlo)
    assert np.array_equal(valid, jvalid)
    assert np.array_equal(cnt.numpy(), jcnt.astype(np.int64))


@pytest.mark.parametrize("cutoff", [0, 1, 3])
def test_count_keys_rids_matches_jax(cutoff):
    jrecs, trecs = _records(4)
    shape = trecs.kmer.shape
    # read ids in no particular order, with repeats, so the rid sort matters
    rids = np.random.default_rng(5).integers(0, 9, size=shape).astype(np.uint32)
    jk = jcount.count_keys_rids(jrecs, jnp.asarray(rids), cutoff=cutoff)
    tk = tcount.count_keys_rids(trecs, torch.from_numpy(rids.astype(np.int64)), cutoff=cutoff)
    hi, lo = convert.key_to_lanes(tk.kmer)
    assert np.array_equal(hi, np.asarray(jk.kmer_hi))
    assert np.array_equal(lo, np.asarray(jk.kmer_lo))
    assert np.array_equal(tk.read_id.numpy(), np.asarray(jk.read_id).astype(np.int64))
    assert np.array_equal(tk.valid.numpy(), np.asarray(jk.valid))
    assert np.array_equal(tk.group_start.numpy(), np.asarray(jk.group_start))
    assert np.array_equal(tk.count.numpy(), np.asarray(jk.count).astype(np.int64))
    assert np.array_equal(tk.keep.numpy(), np.asarray(jk.keep))


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 2), (2, 64), (3, 1000)])
def test_group_counts_matches_jax(seed, n):
    gs = np.random.default_rng(seed).random(n) < 0.3
    gs[0] = True
    want = np.asarray(jcount.group_counts(jnp.asarray(gs)))
    got = tcount.group_counts(torch.from_numpy(gs))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_sentinel_tail_never_kept_with_large_cutoff():
    """The prune pads the shifted keys with the sentinel: on the sentinel
    tail the shifted compare is TRUE, and only `valid` keeps it out."""
    kmer = torch.tensor([[5, 5, 5, 9]], dtype=torch.int64)
    valid = torch.tensor([[True, True, True, False]])
    recs = convert.window_records_from_lanes(
        np.zeros((1, 4), np.uint32), *convert.key_to_lanes(kmer.numpy()), valid.numpy())
    for cutoff in (1, 2, 3, 10):
        kc = tcount.count_keys(recs, cutoff=cutoff)
        assert kc.keep.tolist() == [cutoff < 3, False, False, False]


def test_hash_constants_match_numpy_uint32():
    assert tcommon.HASH_A == int(jcommon.HASH_A)
    assert tcommon.HASH_B == int(jcommon.HASH_B)
    assert tcommon.LINK_HASH_A == int(jcommon.LINK_HASH_A)
    assert tcommon.LINK_HASH_B == int(jcommon.LINK_HASH_B)
    assert tcommon.HASH_A != tcommon.HASH_B
    assert tcommon.SENTINEL == (1 << 63) - 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fmix32_matches_numpy_uint32(seed):
    x = np.random.default_rng(seed).integers(0, 1 << 32, size=4096, dtype=np.uint64)
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    with np.errstate(over="ignore"):
        want = jcommon.fmix32(x.astype(np.uint32))
    got = tcommon.fmix32(torch.from_numpy(x.astype(np.int64)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("a,b", [("HASH_A", "HASH_B"), ("LINK_HASH_A", "LINK_HASH_B")])
def test_two_lane_hash_matches_numpy_uint32(a, b):
    """The (hi*A)^(lo*B) combine, then fmix32, as the partitioners use it."""
    rng = np.random.default_rng(11)
    hi = rng.integers(0, 1 << 30, size=2048, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 1 << 32, size=2048, dtype=np.uint64).astype(np.uint32)
    with np.errstate(over="ignore"):
        want = jcommon.fmix32((hi * getattr(jcommon, a)) ^ (lo * getattr(jcommon, b)))
    thi = torch.from_numpy(hi.astype(np.int64))
    tlo = torch.from_numpy(lo.astype(np.int64))
    mixed = ((thi * getattr(tcommon, a)) & tcommon.MASK32) ^ ((tlo * getattr(tcommon, b)) & tcommon.MASK32)
    assert np.array_equal(tcommon.fmix32(mixed).numpy(), want.astype(np.int64))

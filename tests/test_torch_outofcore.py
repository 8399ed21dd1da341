"""Port vs JAX package: ops/outofcore.py, the out-of-core counters (CPU).

The same keys, made from a seed with numpy, go through the JAX function
and the port's: partition ids bit for bit (keys whose combined hash is all
ones included), the group plan, each extracted partition row as a sorted
multiset with its overflow flag, and the partitioned counts -- kept keys
IN ORDER, counters, overflows, and for parity mode the host table and the
per-group streams -- through ``convert``.  Integers: tolerance 0.

The port's counts take no group width, staging budget or cap of their
own: where the JAX call is given one, the port's ``range_group_plan`` is
patched to the same (``_force_plan``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genome_assembly_tpu import common as jcommon
from genome_assembly_tpu.ops import outofcore as jooc
from genome_assembly_tpu_torch import common as tcommon
from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.ops import bitonic_sort
from genome_assembly_tpu_torch.ops import outofcore as tooc

SENT = tcommon.SENTINEL
M32 = (1 << 32) - 1


def _inverse_fmix32(y: int) -> int:
    """The 32-bit x with fmix32(x) == y (each step of fmix32 is invertible)."""
    y ^= y >> 16
    y = (y * pow(tcommon._FMIX_C2, -1, 1 << 32)) & M32
    y ^= (y >> 13) ^ (y >> 26)
    y = (y * pow(tcommon._FMIX_C1, -1, 1 << 32)) & M32
    y ^= y >> 16
    return y


def _all_ones_keys(a: int, b: int, his) -> np.ndarray:
    """Keys (hi << 32 | lo) whose hash fmix32(hi*a ^ lo*b) is 0xFFFFFFFF."""
    target = _inverse_fmix32(M32)
    out = []
    for hi in his:
        lo = ((target ^ ((hi * a) & M32)) * pow(b, -1, 1 << 32)) & M32
        out.append((hi << 32) | lo)
    return np.asarray(out, dtype=np.int64)


def _keys(seed, n, pool=None, sentinel_share=0.1, extra=()):
    """n int64 keys below 2^62 (drawn from ``pool`` distinct values when
    given, so keys repeat), a share of them SENTINEL, plus ``extra``."""
    rng = np.random.default_rng(seed)
    if pool is None:
        key = rng.integers(0, 1 << 62, size=n, dtype=np.int64)
    else:
        key = rng.choice(rng.integers(0, 1 << 62, size=pool, dtype=np.int64), size=n)
    key[rng.random(n) < sentinel_share] = SENT
    key[: len(extra)] = extra
    return key


def _lanes(key):
    hi, lo = convert.key_to_lanes(key)
    return jnp.asarray(hi), jnp.asarray(lo)


def test_inverse_fmix32_and_all_ones_keys():
    for a, b in ((tcommon.HASH_A, tcommon.HASH_B), (tcommon.LINK_HASH_A, tcommon.LINK_HASH_B)):
        keys = _all_ones_keys(a, b, [0, 1, 12345, (1 << 30) - 1])
        assert (tooc._mix_key(torch.from_numpy(keys), a, b) == M32).all()


@pytest.mark.parametrize("partitions", [1, 3, 7, 64, 65536])
def test_partition_ids_match_jax(partitions):
    extra = np.concatenate([
        _all_ones_keys(tcommon.HASH_A, tcommon.HASH_B, [0, 7, 99]),
        _all_ones_keys(tcommon.LINK_HASH_A, tcommon.LINK_HASH_B, [0, 5, 1 << 29]),
        [0, 1, (1 << 62) - 1]])
    key = _keys(1, 4096, extra=extra)
    valid = key != SENT
    hi, lo = _lanes(key)
    for jfn, tfn in ((jooc.key_partition_range, tooc.key_partition_range),
                     (jooc.link_partition_range, tooc.link_partition_range)):
        want = np.asarray(jfn(hi, lo, partitions)).astype(np.int64)
        got = tfn(torch.from_numpy(key), partitions).numpy()
        assert np.array_equal(got[valid], want[valid])
        assert got[valid].max() < partitions


def test_range_lower_bound_matches_jax():
    for partitions in (1, 2, 3, 7, 100, 65536):
        p = np.arange(min(partitions + 3, 200), dtype=np.int64)
        want = np.asarray(jooc._range_lower_bound(jnp.asarray(p.astype(np.uint32)), partitions))
        got = tooc._range_lower_bound(torch.from_numpy(p), partitions).numpy()
        assert np.array_equal(got, want.astype(np.int64)), partitions


def test_range_group_plan_matches_jax():
    for n_units in (1, 3, 77):
        for unit_records in (100, 4096, 6_422_528):
            for partitions in (1, 4, 11, 65536):
                for bpr, budget, gs, sigma in ((8, 8 << 30, None, 1.0), (12, 5 << 30, None, 2.9),
                                               (20, 1 << 20, None, 1.0), (8, 6 << 30, 5, 1.0)):
                    kw = dict(partitions=partitions, bytes_per_record=bpr,
                              budget_bytes=budget, group_size=gs, sigma_scale=sigma)
                    assert tooc.range_group_plan(n_units, unit_records, **kw) == \
                        jooc.range_group_plan(n_units, unit_records, **kw)


# (partitions, group_size, group, cap_bp): clean, overflowing, the last
# group's overhang past P, one partition a pass
EXTRACT_CASES = [(7, 3, 0, 700), (7, 3, 2, 700), (5, 2, 1, 250), (4, 1, 3, 2048), (1, 1, 0, 2048)]


def _rows_equal(got, want_rows):
    """Each partition row of the port equals the JAX row as a sorted multiset."""
    for g, w in zip(got, want_rows):
        assert np.array_equal(np.sort(g.numpy()), np.sort(w))


@pytest.mark.parametrize("case", EXTRACT_CASES)
def test_extract_partition_range_matches_jax(case):
    partitions, G, g, cap = case
    extra = _all_ones_keys(tcommon.HASH_A, tcommon.HASH_B, range(40))
    key = _keys(2, 2048, pool=900, extra=extra)
    jhi, jlo, jovf = jooc.extract_partition_range(
        *_lanes(key), jnp.uint32(g), partitions=partitions, group_size=G, cap_bp=cap)
    keys, ovf = tooc.extract_partition_range(
        torch.from_numpy(key), g, partitions=partitions, group_size=G, cap_bp=cap)
    assert keys.shape == (G, cap) and ovf.dtype == torch.bool
    assert ovf.tolist() == np.asarray(jovf).tolist()
    _rows_equal(keys, [convert.lanes_to_key(h, l) for h, l in zip(np.asarray(jhi), np.asarray(jlo))])


def test_extract_keeps_keys_whose_hash_is_all_ones():
    """Keys hashing to 0xFFFFFFFF sort before the invalid run (the clamp),
    land in the last partition and are all extracted; one slot fewer than
    there are of them is an overflow."""
    extra = _all_ones_keys(tcommon.HASH_A, tcommon.HASH_B, range(50))
    key = np.concatenate([extra, np.full(200, SENT, np.int64)])
    keys, ovf = tooc.extract_partition_range(
        torch.from_numpy(key), 0, partitions=3, group_size=3, cap_bp=49)
    assert ovf.tolist() == [False, False, True]
    keys, ovf = tooc.extract_partition_range(
        torch.from_numpy(key), 0, partitions=3, group_size=3, cap_bp=50)
    assert ovf.tolist() == [False, False, False]
    assert sorted(keys[2].tolist()) == sorted(extra.tolist())


@pytest.mark.parametrize("case", EXTRACT_CASES[:3])
def test_extract_partition_range3_matches_jax(case):
    partitions, G, g, cap = case
    extra = _all_ones_keys(tcommon.LINK_HASH_A, tcommon.LINK_HASH_B, range(40))
    key = _keys(3, 2048, pool=700, extra=extra)
    key[key != SENT] &= (1 << 60) - 1  # (k-1)-mers
    rng = np.random.default_rng(4)
    pay = rng.integers(0, 1 << 31, size=key.shape[0], dtype=np.int64)
    jhi, jlo, jpay, jovf = jooc.extract_partition_range3(
        *_lanes(key), jnp.asarray(pay.astype(np.uint32)), jnp.uint32(g),
        partitions=partitions, group_size=G, cap_bp=cap)
    keys, pays, ovf = tooc.extract_partition_range3(
        torch.from_numpy(key), torch.from_numpy(pay), g,
        partitions=partitions, group_size=G, cap_bp=cap)
    assert ovf.tolist() == np.asarray(jovf).tolist()
    # the (key, payload) pairs of each row, as multisets
    for r in range(G):
        want_key = convert.lanes_to_key(np.asarray(jhi[r]), np.asarray(jlo[r]))
        want_pay = np.where(want_key == SENT, SENT, np.asarray(jpay[r]).astype(np.int64))
        assert sorted(zip(keys[r].tolist(), pays[r].tolist())) == \
            sorted(zip(want_key.tolist(), want_pay.tolist()))


def _parity_batch(seed, n, invalid_share=0.1, all_ones=0):
    """One batch of parity lanes with many repeated (mmer, kmer) groups:
    (JAX uint32 lanes, port lanes).  The first ``all_ones`` records are
    (mmer 0, kmer lo) with a parity hash of all ones."""
    rng = np.random.default_rng(seed)
    mm = rng.integers(0, 6, n).astype(np.int64)
    hi = rng.integers(0, 3, n).astype(np.int64)
    lo = rng.integers(0, 7, n).astype(np.int64)
    mm[:all_ones], hi[:all_ones] = 0, 0
    lo[:all_ones] = (_inverse_fmix32(M32) * pow(0x9E3779B9, -1, 1 << 32)) & M32
    rid = rng.integers(0, 50, n).astype(np.int64)
    stream = np.arange(n, dtype=np.int64) + seed * n
    invalid = rng.random(n) < invalid_share
    invalid[:all_ones] = False
    jmm = np.where(invalid, 0xFFFFFFFF, mm).astype(np.uint32)
    j = tuple(jnp.asarray(a.astype(np.uint32)) for a in (jmm, hi, lo, rid, stream))
    t = (torch.from_numpy(np.where(invalid, tcommon.MMER_SENTINEL, mm).astype(np.int32)),
         torch.from_numpy(np.where(invalid, SENT, (hi << 32) | lo)),
         torch.from_numpy(rid), torch.from_numpy(stream))
    return j, t


@pytest.mark.parametrize("case", EXTRACT_CASES[:3])
def test_extract_partition_range5_matches_jax(case):
    partitions, G, g, cap = case
    jl, tl = _parity_batch(0, 2048, all_ones=5)
    assert (tooc._parity_hash(tl[0][:5], tl[1][:5]) == M32).all()
    *want, jovf = jooc.extract_partition_range5(
        *jl, jnp.uint32(g), partitions=partitions, group_size=G, cap_bp=cap)
    *got, ovf = tooc.extract_partition_range5(
        *tl, g, partitions=partitions, group_size=G, cap_bp=cap)
    assert ovf.tolist() == np.asarray(jovf).tolist()
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.int64
    for r in range(G):
        w = [np.asarray(x[r]).astype(np.int64) for x in want]
        wkey = convert.lanes_to_key(w[1], w[2])
        wm = np.where(w[0] == 0xFFFFFFFF, tcommon.MMER_SENTINEL, w[0])
        wrid = np.where(wkey == SENT, SENT, w[3])
        wst = np.where(wkey == SENT, SENT, w[4])
        assert sorted(zip(*(x[r].tolist() for x in got))) == \
            sorted(zip(wm.tolist(), wkey.tolist(), wrid.tolist(), wst.tolist()))


# -- partitioned_count --------------------------------------------------

def _force_plan(monkeypatch, module, cap=None, **force):
    """module.range_group_plan with some of its arguments forced, and with
    ``cap`` = (divisor, floor) a cap of max(floor, unit_records // divisor)
    far below every partition's share."""
    real = module.range_group_plan

    def plan(n_units, unit_records, **kw):
        cap_bp, G = real(n_units, unit_records, **{**kw, **force})
        return (cap_bp if cap is None else max(cap[1], unit_records // cap[0])), G
    monkeypatch.setattr(module, "range_group_plan", plan)


N_BATCHES, BATCH_SLOTS = 3, 2048


def _count_batches():
    return [_keys(10 + b, BATCH_SLOTS, pool=1500) for b in range(N_BATCHES)]


def _run_both(batches, *, hybrid_sort=False, jax_kw=None, **kw):
    """JAX's pallas_sort is the port's hybrid_sort; ``jax_kw`` goes to the
    JAX call alone (its group width and budget knobs)."""
    want = jooc.partitioned_count(lambda b: _lanes(batches[b]), len(batches),
                                  pallas_sort=hybrid_sort, kept_cap=1 << 20,
                                  **kw, **(jax_kw or {}))
    got = tooc.partitioned_count(lambda b: torch.from_numpy(batches[b]), len(batches),
                                 hybrid_sort=hybrid_sort, **kw)
    return want, got


def _same_count(want, got):
    assert np.array_equal(got.kmer.numpy(), convert.lanes_to_key(want.kmer_hi, want.kmer_lo))
    assert got.kmer.dtype == torch.int64 and bool(got.valid.all())
    for f in ("n_distinct", "n_kept", "group_size", "partitions"):
        assert getattr(got, f) == getattr(want, f), f
    assert want.batch_overflows == 0 and not want.kept_overflow


@pytest.mark.parametrize("partitions,group_size", [(1, None), (5, 2), (7, None), (4, 4)])
def test_partitioned_count_matches_jax(monkeypatch, partitions, group_size):
    if group_size is not None:
        _force_plan(monkeypatch, tooc, group_size=group_size)
    want, got = _run_both(_count_batches(), partitions=partitions, cutoff=1,
                          jax_kw=dict(group_size=group_size))
    _same_count(want, got)
    assert got.n_kept > 100


def test_partitioned_count_budget_group(monkeypatch):
    """G taken from a small staging budget: 2 partitions a pass."""
    _force_plan(monkeypatch, tooc, budget_bytes=30_000)
    want, got = _run_both(_count_batches(), partitions=6, cutoff=0,
                          jax_kw=dict(group_budget_bytes=30_000))
    _same_count(want, got)
    assert got.group_size == 2


def test_partitioned_count_forced_cap_overflow_self_heals(monkeypatch, caplog):
    """A staging cap far below every partition's share: every partition
    of the one group pass overflows and is re-extracted alone, in
    partition order -- so the keys equal the JAX package's clean count,
    in order."""
    _force_plan(monkeypatch, tooc, cap=(32, 16))
    with caplog.at_level("WARNING"):
        want, got = _run_both(_count_batches(), partitions=4, cutoff=1)
    _same_count(want, got)
    healed = [r.args[1] for r in caplog.records if "re-extracting alone" in r.message]
    assert sorted(set(healed)) == [0, 1, 2, 3]


def test_partitioned_count_hybrid_sort_matches_jax(monkeypatch):
    """hybrid_sort on CPU tensors: the partition counts drive the bitonic
    network's plain passes; the keys equal the JAX package's (whose
    pallas_sort takes lax.sort off the TPU)."""
    monkeypatch.setattr(bitonic_sort, "DEFAULT_LIB_CHUNK", 256)
    monkeypatch.setattr(bitonic_sort, "DEFAULT_CHUNK", 32)
    passes = []
    real = bitonic_sort.big_ce_plain
    monkeypatch.setattr(bitonic_sort, "big_ce_plain",
                        lambda *a, **kw: (passes.append(1), real(*a, **kw))[1])
    want, got = _run_both(_count_batches(), partitions=3, cutoff=1,
                          hybrid_sort=True)
    assert passes, "the partition counts did not reach the network"
    _same_count(want, got)


def test_partitioned_count_self_heals_in_the_jax_order(caplog):
    """Half of every batch is ONE key (tests/test_count.py's construction):
    its partition blows the statistical cap, is re-extracted alone after
    the group's clean partitions, and the keys come out in the JAX order."""
    rng = np.random.default_rng(41)
    slots, n = 4096, 2
    batches = []
    for _ in range(n):
        hi = np.concatenate([np.full(slots // 2, 7), rng.integers(0, 1 << 20, slots // 2)])
        lo = np.concatenate([np.full(slots // 2, 9), rng.integers(0, 1 << 30, slots // 2)])
        batches.append(((hi << 32) | lo).astype(np.int64))
    with caplog.at_level("WARNING"):
        want, got = _run_both(batches, partitions=4, cutoff=1)
    _same_count(want, got)
    assert any("re-extracting alone" in r.message for r in caplog.records)
    heavy = tooc.key_partition_range(torch.tensor([(7 << 32) | 9]), 4).item()
    # the healed partition's keys are the last ones out
    pids = tooc.key_partition_range(got.kmer, 4)
    assert pids[-1].item() == heavy and heavy != 3


# -- partitioned_count_parity ----------------------------------------------

def _parity_both(n_batches=2, n=96, jax_kw=None, **kw):
    pairs = [_parity_batch(b, n) for b in range(n_batches)]
    want = jooc.partitioned_count_parity(lambda b: pairs[b][0], n_batches, **kw,
                                         **(jax_kw or {}))
    got = tooc.partitioned_count_parity(lambda b: pairs[b][1], n_batches, **kw)
    return want, got


def _same_host(want, got):
    w = convert.host_table_from_lanes(*want)
    for name in ("mmer", "kmer", "count", "first_seen"):
        a, b = getattr(got, name), getattr(w, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert len(got.read_ids) == len(w.read_ids)
    for a, b in zip(got.read_ids, w.read_ids):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("cutoff", [-1, 1])
@pytest.mark.parametrize("partitions,group_size", [(4, None), (5, 2)])
def test_partitioned_count_parity_matches_jax(monkeypatch, cutoff, partitions, group_size):
    if group_size is not None:
        _force_plan(monkeypatch, tooc, group_size=group_size)
    want, got = _parity_both(partitions=partitions, cutoff=cutoff,
                             jax_kw=dict(group_size=group_size))
    _same_host(want[0], got[0])
    assert got[1:] == want[1:]
    assert len(got[0].mmer) > 10


@pytest.mark.parametrize("cutoff", [-1, 0])
def test_partitioned_count_parity_streams_match_jax(cutoff):
    want, got = _parity_both(n_batches=3, partitions=3, cutoff=cutoff, with_streams=True)
    _same_host(want[0], got[0])
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[2:] == want[2:]
    # each group's streams ascend and start at its first-seen index
    assert all(int(s[0]) == int(f) and (np.diff(s.astype(np.int64)) > 0).all()
               for s, f in zip(got[1], got[0].first_seen))


def test_partitioned_count_parity_forced_cap_overflow_is_reported(monkeypatch):
    """The same cap far below every partition's share in both packages:
    the overflow is reported, not healed, and the incomplete tables agree."""
    for module in (jooc, tooc):
        _force_plan(monkeypatch, module, cap=(8, 8))
    want, got = _parity_both(partitions=4, cutoff=-1)
    _same_host(want[0], got[0])
    assert got[1:] == want[1:] and got[2] > 0


# -- checkpoints, workers, pid lists -------------------------------------------

class _Killed(Exception):
    pass


def test_partitioned_count_resumes_after_a_kill(monkeypatch, tmp_path):
    """Killed during its second pass: the first pass's partitions are on
    disk, the resumed call skips their group (no re-scan) and gives the
    same keys in order as an uninterrupted run and the JAX package."""
    _force_plan(monkeypatch, tooc, group_size=2)
    batches = _count_batches()
    want, fresh = _run_both(batches, partitions=5, cutoff=1, jax_kw=dict(group_size=2))
    made = []

    def keys(b, kill_at=None):
        made.append(b)
        if kill_at is not None and len(made) == kill_at:
            raise _Killed
        return torch.from_numpy(batches[b])
    ck = str(tmp_path / "ck")
    with pytest.raises(_Killed):  # the probe, one pass of 3 batches, then a kill
        tooc.partitioned_count(lambda b: keys(b, kill_at=6), 3, partitions=5, cutoff=1,
                               checkpoint_dir=ck)
    assert sorted(p.name for p in tmp_path.joinpath("ck").glob("part_*.npz")) == \
        ["part_0.npz", "part_1.npz"]
    made.clear()
    got = tooc.partitioned_count(keys, 3, partitions=5, cutoff=1, checkpoint_dir=ck)
    assert made == [0] + [0, 1, 2] * 2 and got.passes == 2
    _same_count(want, got)
    assert torch.equal(got.kmer, fresh.kmer)
    # every part saved: a third call makes no pass, return_host gives numpy
    made.clear()
    again = tooc.partitioned_count(keys, 3, partitions=5, cutoff=1, checkpoint_dir=ck,
                                   return_host=True)
    assert made == [0] and again.passes == 0
    assert isinstance(again.kmer, np.ndarray) and np.array_equal(again.kmer, fresh.kmer.numpy())


def test_partitioned_count_directories_resume_across_packages(tmp_path):
    """Worker ranges written by one package, merged by the other with no
    re-scan: the keys equal a fresh JAX count in order; the part files hold
    uint32 khi/klo lanes and int64 counters."""
    batches = _count_batches()
    want = jooc.partitioned_count(lambda b: _lanes(batches[b]), 3, partitions=6, cutoff=1,
                                  kept_cap=1 << 20)
    for writer in ("jax", "port"):
        ck = str(tmp_path / writer)
        for lo, hi in ((0, 3), (3, 6)):
            if writer == "jax":
                jooc.partitioned_count(lambda b: _lanes(batches[b]), 3, partitions=6, cutoff=1,
                                       kept_cap=1 << 20, checkpoint_dir=ck,
                                       only_partitions=(lo, hi), dataset_tag="d")
            else:
                tooc.partitioned_count(lambda b: torch.from_numpy(batches[b]), 3,
                                       partitions=6, cutoff=1, checkpoint_dir=ck,
                                       only_partitions=(lo, hi), dataset_tag="d")
        saved = np.load(tmp_path / writer / "part_0.npz")
        assert saved["khi"].dtype == np.uint32 and saved["klo"].dtype == np.uint32
        assert saved["n_kept"].dtype == np.int64 and int(saved["batch_overflows"]) == 0
        if writer == "jax":
            made = []
            got = tooc.partitioned_count(lambda b: (made.append(b), torch.from_numpy(
                batches[b]))[1], 3, partitions=6, cutoff=1, checkpoint_dir=ck, dataset_tag="d")
            assert made == [0] and got.passes == 0
            _same_count(want, got)
        else:
            got = jooc.partitioned_count(lambda b: _lanes(batches[b]), 3, partitions=6,
                                         cutoff=1, kept_cap=1 << 20, checkpoint_dir=ck,
                                         dataset_tag="d")
            assert np.array_equal(convert.lanes_to_key(got.kmer_hi, got.kmer_lo),
                                  convert.lanes_to_key(want.kmer_hi, want.kmer_lo))
            assert (got.n_kept, got.n_distinct) == (want.n_kept, want.n_distinct)


def test_partitioned_count_refuses_foreign_directories_and_empty_ranges(tmp_path):
    batches = _count_batches()

    def keys(b):
        return torch.from_numpy(batches[b])
    tooc.partitioned_count(keys, 3, partitions=4, cutoff=1, checkpoint_dir=str(tmp_path),
                           dataset_tag="vg-ctr-seed0")
    meta = (tmp_path / "meta.json").read_text()
    assert '"scheme": "range16"' in meta and '"format": 5' in meta
    for kw in (dict(partitions=5, dataset_tag="vg-ctr-seed0"),
               dict(partitions=4, dataset_tag="gen-ctr-seed0"), dict(partitions=4)):
        with pytest.raises(ValueError, match="different configuration"):
            tooc.partitioned_count(keys, 3, cutoff=1, checkpoint_dir=str(tmp_path), **kw)
    with pytest.raises(ValueError, match="owns nothing"):
        tooc.partitioned_count(keys, 3, partitions=4, cutoff=1, checkpoint_dir=str(tmp_path),
                               dataset_tag="vg-ctr-seed0", only_partitions=(4, 8))
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        tooc.partitioned_count(keys, 3, partitions=4, cutoff=1, only_partitions=(0, 2))


def test_partitioned_count_reports_progress_per_batch():
    batches = _count_batches()
    seen = []
    tooc.partitioned_count(lambda b: torch.from_numpy(batches[b]), 3, partitions=3, cutoff=1,
                           on_progress=lambda *a: seen.append(a))
    assert seen == [(0, 1, b, 3) for b in (1, 2, 3)]


@pytest.mark.parametrize("extract,n_lanes", [(tooc.extract_partition_range, 1),
                                             (tooc.extract_partition_range3, 2)])
def test_stage_group_takes_a_list_of_partition_ids(extract, n_lanes):
    """A pid list stages the same rows as the consecutive groups that hold
    its ids; an id past the partitions stages only fill."""
    batches = [torch.from_numpy(k) for k in _count_batches()]

    def records(u):
        return (batches[u],) * n_lanes
    kw = dict(partitions=6, cap_bp=800, dtypes=(torch.int64,) * n_lanes)
    listed, ovf = tooc.stage_group(records, 3, extract, [4, 1, 9], **kw)
    by_group = {}
    for g in (0, 1):
        parts, govf = tooc.stage_group(records, 3, extract, g, group_size=3, **kw)
        for r in range(3):
            by_group[g * 3 + r] = (parts[r], govf[r])
    for (lanes, o), p in zip(zip(listed, ovf), [4, 1]):
        assert all(torch.equal(a, b) for a, b in zip(lanes, by_group[p][0]))
        assert o == by_group[p][1]
    assert all((lane == SENT).all() for lane in listed[2]) and ovf[2] == 0

"""Port vs JAX package: parity mode's count and host table (CPU).

The same numpy-seeded batches go through the JAX ``parity_scan`` +
``count_and_prune`` (+ ``merge_sorted_tables`` over several batches) and
through the port's, then through ``extract_groups[_with_streams]`` and
``decode_table``; ``convert.py`` carries the tables across.  The port
sorts a lane a pass, so k = 31, m = 4 (70 bits of key) is sorted as
k = 6 is.  Integers only: tolerance 0.

The JAX table leaves the k-mer lanes of its invalid tail as the padding
packs them, so those rows sort among themselves in an order of no
meaning; the port writes sentinels there.  Rows are compared on the valid
prefix, and the invalid rows by their count.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genome_assembly_tpu.io import reads as jreads
from genome_assembly_tpu.ops import count as jcount
from genome_assembly_tpu.ops import minimizer as jmin
from genome_assembly_tpu.parity import table as jtable
from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.ops import count as tcount
from genome_assembly_tpu_torch.ops import minimizer as tmin
from genome_assembly_tpu_torch.parity import table as ttable

KM = [(6, 3), (8, 4), (31, 4)]


def _reads(seed, n, length, alphabet="ACGT"):
    """Reads over a small alphabet repeat their windows, so groups have
    several occurrences and some cross batch boundaries."""
    rng = np.random.default_rng(seed)
    reads = ["".join(rng.choice(list(alphabet), size=int(rng.integers(0, length + 1))))
             for _ in range(n)]
    return reads + reads[: n // 2]


def _tables(reads, k, m, batch, cutoff):
    """(JAX tables, port tables) of each batch, counted as the pipelines
    count them: the given cutoff for one batch, -1 for several."""
    # 43 windows a row at every k: one shape for the JAX merge to compile
    n_win = 43
    batches = jreads.batch_reads(reads, k + n_win - 1, batch, parity_chars=True)
    if len(batches) > 1:
        batches[-1] = jreads.pad_batch(batches[-1], batch)
        cutoff = -1
    jt, tt = [], []
    for bi, b in enumerate(batches):
        offset = bi * batch * n_win
        jr = jmin.parity_scan(jnp.asarray(b.codes), jnp.asarray(b.lengths), k=k, m=m)
        jt.append(jcount.count_and_prune(jr, jnp.asarray(b.read_ids), cutoff=cutoff,
                                         stream_offset=offset))
        codes, lengths, rids = convert.read_batch_to_torch(b)
        tr = tmin.parity_scan(codes, lengths, k=k, m=m)
        tt.append(tcount.count_and_prune(tr, rids, cutoff=cutoff, stream_offset=offset))
    return jt, tt


def _assert_tables(jax_table, got):
    want = convert.counted_table_to_lanes(got)  # port -> JAX lanes
    theirs = [np.asarray(x) for x in jax_table]
    valid = theirs[5]
    n = int(valid.sum())
    assert int(got.valid.sum()) == n and valid[:n].all()
    assert got.kmer.shape[0] == valid.shape[0]
    names = ("mmer", "kmer_hi", "kmer_lo", "read_id", "stream_idx", "valid",
             "group_start", "count", "keep")
    for name, ours, jax_lane in zip(names, want, theirs):
        np.testing.assert_array_equal(ours[:n], jax_lane[:n], err_msg=name)
    np.testing.assert_array_equal(want[8], theirs[8], err_msg="keep")
    assert int(got.n_entries) == int(jax_table.n_entries)
    assert int(got.n_kept) == int(jax_table.n_kept)
    assert got.mmer.dtype == torch.int32 and got.kmer.dtype == torch.int64
    for lane in (got.read_id, got.stream_idx, got.count):
        assert lane.dtype == torch.int64


@pytest.mark.parametrize("k,m", KM)
@pytest.mark.parametrize("cutoff", [1, 0, -1])
def test_count_and_prune_matches_jax(k, m, cutoff):
    jt, tt = _tables(_reads(k + m, 60, 40, "ACG"), k, m, 128, cutoff)
    assert len(tt) == 1
    _assert_tables(jt[0], tt[0])
    assert int(tt[0].n_kept) > 0


@pytest.mark.parametrize("k,m", [(6, 3), (31, 4)])
def test_merge_sorted_tables_matches_jax_and_equals_one_batch(k, m):
    reads = _reads(2 * k + m, 60, 40, "ACG")
    jt, tt = _tables(reads, k, m, 16, 1)
    assert len(tt) == 6
    merged = tcount.merge_sorted_tables(tt, cutoff=1)
    _assert_tables(jcount.merge_sorted_tables(jt, cutoff=1), merged)
    # the same reads in one batch give the same valid rows
    _, (one,) = _tables(reads, k, m, 128, 1)
    n = int(one.valid.sum())
    assert int(merged.valid.sum()) == n
    for lane in ("mmer", "kmer", "read_id", "group_start", "count", "keep"):
        assert torch.equal(getattr(merged, lane)[:n], getattr(one, lane)[:n]), lane
    # stream is a key of the merge: the tables in another order merge alike
    again = tcount.merge_sorted_tables(tt[::-1], cutoff=1)
    for a, b in zip(again, merged):
        assert torch.equal(a[:n], b[:n])


@pytest.mark.parametrize("with_minor", [False, True])
def test_lane_by_lane_order_is_stable_and_sorted(with_minor):
    """The pass-a-lane sort orders rows by (mmer, kmer[, stream]) and
    keeps input order among equal keys; k-mers use all 62 bits."""
    gen = torch.Generator().manual_seed(5)
    mmer = torch.randint(0, 8, (5000,), generator=gen, dtype=torch.int32)
    kmer = torch.randint(0, 4, (5000,), generator=gen) << 60
    kmer[::7] = tcount.SENTINEL
    mmer[::7] = tcount.MMER_SENTINEL
    stream = torch.randperm(5000, generator=gen)
    minor = stream if with_minor else None
    order = tcount._mmer_kmer_order(mmer, kmer, minor=minor)
    tie = stream if with_minor else torch.arange(5000)
    keys = list(zip(mmer[order].tolist(), kmer[order].tolist(), tie[order].tolist()))
    assert keys == sorted(keys)


@pytest.mark.parametrize("k,m", [(6, 3), (31, 4)])
@pytest.mark.parametrize("pruned", [True, False])
def test_extract_groups_and_decode_table_match_jax(k, m, pruned):
    jt, tt = _tables(_reads(k, 60, 40, "ACG"), k, m, 16, 1)
    jm = jcount.merge_sorted_tables(jt, cutoff=1)
    tm = tcount.merge_sorted_tables(tt, cutoff=1)
    jhost, jstreams = jtable.extract_groups_with_streams(jm, pruned=pruned)
    thost, tstreams = ttable.extract_groups_with_streams(tm, pruned=pruned)
    assert len(thost.mmer) == len(jhost.mmer) > 0
    got = convert.host_table_to_lanes(thost)
    for name, ours, theirs in zip(jtable.HostTable._fields, got, jhost):
        if name == "read_ids":
            assert len(ours) == len(theirs)
            for a, b in zip(ours, theirs):
                assert a.dtype == np.uint32
                np.testing.assert_array_equal(a, b)
        else:
            assert ours.dtype == np.asarray(theirs).dtype, name
            np.testing.assert_array_equal(ours, theirs, err_msg=name)
    for a, b in zip(tstreams, jstreams):
        np.testing.assert_array_equal(a, b)
    plain = ttable.extract_groups(tm, pruned=pruned)
    for a, b in zip(plain[:4], thost[:4]):
        np.testing.assert_array_equal(a, b)
    assert ttable.decode_table(thost, k, m) == jtable.decode_table(jhost, k, m)
    # the converter carries a JAX HostTable across unchanged
    back = convert.host_table_from_lanes(*jhost)
    for a, b in zip(back[:4], thost[:4]):
        np.testing.assert_array_equal(a, b)


def test_counted_table_converts_both_ways():
    jt, _ = _tables(_reads(1, 40, 40, "ACG"), 6, 3, 128, 1)
    lanes = [np.asarray(x) for x in jt[0]]
    ours = convert.counted_table_from_lanes(*lanes)
    back = convert.counted_table_to_lanes(ours)
    n = int(lanes[5].sum())
    for a, b in zip(back, lanes):
        np.testing.assert_array_equal(a[:n], b[:n])
    assert bool((ours.kmer[n:] == tcount.SENTINEL).all())
    assert bool((ours.mmer[n:] == tcount.MMER_SENTINEL).all())

"""Port vs JAX package: ops/superkmer.py and the super-k-mer out-of-core
count of ops/outofcore.py (CPU).

The same reads, made from a seed with numpy, go through both packages:
``super_records`` and ``expand_records`` lane for lane through
``convert.super_records_{to,from}_lanes`` (a slot holds a record iff its
mmer lane says so), the minimizer-partition extraction row for row as
multisets, and ``partitioned_count_super`` -- the kept keys IN ORDER and
its counters -- with the default ragged groups, a self-heal (the probe
batch's caps too small for later batches), the subrange counter (forced in
both packages by patching ``SUB_COUNT_SLOTS``) and ``only_partitions``
workers merged through one checkpoint directory.  Integers: tolerance 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genome_assembly_tpu.ops import outofcore as jooc
from genome_assembly_tpu.ops import superkmer as jsk
from genome_assembly_tpu_torch import common as tcommon
from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.ops import minimizer
from genome_assembly_tpu_torch.ops import outofcore as tooc
from genome_assembly_tpu_torch.ops import superkmer as tsk

SENT = tcommon.SENTINEL


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread for this module's small tensors: under parallel test
    workers that share the cores, each op's thread team otherwise waits on
    threads the other workers hold (the results do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reads(seed, n, max_len, *, genome=None, short_share=0.15, all_a=0):
    """(codes [n, max_len] uint8, lengths int32): reads of a random genome
    (so minimizer runs and k-mers repeat), a share of them shorter (empty
    ones too), the first ``all_a`` rows all A (code 3: words of all ones)."""
    rng = np.random.default_rng(seed)
    if genome is None:
        genome = rng.integers(0, 4, 4 * n + max_len).astype(np.uint8)
    starts = rng.integers(0, genome.size - max_len, n)
    codes = genome[starts[:, None] + np.arange(max_len)[None, :]].copy()
    lengths = np.full(n, max_len, np.int32)
    short = rng.random(n) < short_share
    lengths[short] = rng.integers(0, max_len, int(short.sum()))
    codes[:all_a] = 3
    lengths[:all_a] = max_len
    codes[np.arange(max_len)[None, :] >= lengths[:, None]] = 0
    return codes, lengths


@pytest.mark.parametrize("k,m,max_len", [(31, 7, 128), (21, 5, 100), (11, 3, 40), (31, 15, 64)])
def test_super_records_match_jax(k, m, max_len):
    codes, lengths = _reads(k, 400, max_len, all_a=30)
    want = [np.asarray(x) for x in jsk.super_records(jnp.asarray(codes), jnp.asarray(lengths),
                                                     k=k, m=m)]
    got = tsk.super_records(torch.from_numpy(codes), torch.from_numpy(lengths), k=k, m=m)
    assert [x.dtype for x in got] == list(tsk.DTYPES)
    assert all(x.shape == (400 * (max_len - k + 1),) for x in got)
    lanes = convert.super_records_to_lanes(*got)
    for a, b in zip(lanes, want):
        assert np.array_equal(a, b)
    back = convert.super_records_from_lanes(*want)
    assert all(torch.equal(a, b) for a, b in zip(back, got))
    rec = want[0] != 0xFFFFFFFF
    # the all-A rows give base lanes of all ones that are real records
    assert (rec & (want[2] == 0xFFFFFFFF)).any()
    assert rec.sum() > 100 and (want[1][rec] <= tsk.S_CAP).all()


@pytest.mark.parametrize("k,m", [(31, 7), (21, 5), (11, 3)])
def test_expand_records_match_jax_and_the_source_scan(k, m):
    """Expanded keys equal the JAX package's, row for row; as a multiset
    they are the source batch's valid window keys."""
    codes, lengths = _reads(100 + k, 300, 90, all_a=10)
    recs = tsk.super_records(torch.from_numpy(codes), torch.from_numpy(lengths), k=k, m=m)
    sel = torch.nonzero(recs[0] != tcommon.MMER_SENTINEL).reshape(-1)
    rows = [x[sel] for x in recs]
    got = tsk.expand_records(*rows, k=k, m=m)
    jl = [jnp.asarray(x) for x in convert.super_records_to_lanes(*rows)]
    hi, lo = jsk.expand_records(*jl, k=k, m=m)
    assert got.shape == (sel.shape[0] * tsk.S_CAP,)
    assert np.array_equal(got.numpy(), convert.lanes_to_key(np.asarray(hi), np.asarray(lo)))
    scan = minimizer.fast_scan(torch.from_numpy(codes), torch.from_numpy(lengths), k=k, m=m)
    assert torch.equal(torch.sort(got[got != SENT]).values,
                       torch.sort(scan.kmer[scan.valid]).values)
    # non-record slots expand to nothing
    blank = [x[:4].clone() for x in rows]
    blank[0][:] = tcommon.MMER_SENTINEL
    assert (tsk.expand_records(*blank, k=k, m=m) == SENT).all()


def test_super_records_refuse_k_past_31():
    with pytest.raises(ValueError):
        tsk.super_records(torch.zeros((2, 40), dtype=torch.uint8),
                          torch.zeros(2, dtype=torch.int32), k=33, m=7)


@pytest.mark.parametrize("group", [0, 2, [3, 0, 6], [5, 9, 1]])
def test_extract_partition_range_super_matches_jax(group):
    """Consecutive groups and pid lists (a pid >= P is inert), rows as
    multisets of records, overflow flags equal."""
    codes, lengths = _reads(5, 600, 64)
    recs = tsk.super_records(torch.from_numpy(codes), torch.from_numpy(lengths), k=21, m=5)
    jl = [jnp.asarray(x) for x in convert.super_records_to_lanes(*recs)]
    partitions, cap = 7, 600
    if isinstance(group, int):
        jarg, G, targ = jnp.uint32(group * 3), 3, group
    else:
        jarg, G, targ = jnp.asarray(np.asarray(group, np.uint32)), len(group), \
            torch.tensor(group)
    *want, wovf = jooc.extract_partition_range_super(
        *jl, jarg, partitions=partitions, group_size=G, cap_bp=cap)
    *got, ovf = tooc.extract_partition_range_super(
        *recs, targ, partitions=partitions, group_size=G, cap_bp=cap)
    assert ovf.tolist() == np.asarray(wovf).tolist()
    for r in range(G):
        w = convert.super_records_to_lanes(*convert.super_records_from_lanes(
            *(np.asarray(x[r]) for x in want)))
        g = convert.super_records_to_lanes(*(x[r] for x in got))
        assert sorted(zip(*(a.tolist() for a in g))) == sorted(zip(*(a.tolist() for a in w)))
    if not isinstance(group, int) and max(group) >= partitions:
        assert (got[0][[i for i, p in enumerate(group) if p >= partitions]]
                == tcommon.MMER_SENTINEL).all()


# -- partitioned_count_super -------------------------------------------------

K, M = 21, 7
GENOME = np.random.default_rng(77).integers(0, 4, 12_000).astype(np.uint8)


def _batches(n_batches=4, n=1024, max_len=64, probe_len=None):
    """Reads of one genome; with ``probe_len`` batch 0's reads are that
    short, so its histogram under-sizes every later batch's caps."""
    out = []
    for b in range(n_batches):
        codes, lengths = _reads(200 + b, n, max_len, genome=GENOME)
        if probe_len is not None and b == 0:
            lengths = np.minimum(lengths, probe_len).astype(np.int32)
            codes[np.arange(max_len)[None, :] >= lengths[:, None]] = 0
        out.append((codes, lengths))
    return out


def _expand(monkeypatch, expand_slots_budget, expand_chunk):
    """The port's expansion sizes patched to the values the JAX call is
    given; returns them as the JAX call's keywords."""
    monkeypatch.setattr(tooc, "EXPAND_SLOTS_BUDGET", expand_slots_budget)
    monkeypatch.setattr(tooc, "EXPAND_CHUNK", expand_chunk)
    return dict(expand_slots_budget=expand_slots_budget, expand_chunk=expand_chunk)


def _super_both(monkeypatch, batches, *, expand_slots_budget, expand_chunk=1024, **kw):
    jb = [jsk.super_records(jnp.asarray(c), jnp.asarray(l), k=K, m=M) for c, l in batches]
    tb = [tsk.super_records(torch.from_numpy(c), torch.from_numpy(l), k=K, m=M)
          for c, l in batches]
    jax_kw = _expand(monkeypatch, expand_slots_budget, expand_chunk)
    want = jooc.partitioned_count_super(lambda b: jb[b], len(batches), k=K, m=M,
                                        kept_cap=1 << 22, **kw, **jax_kw)
    got = tooc.partitioned_count_super(lambda b: tb[b], len(batches), k=K, m=M, **kw)
    return want, got


def _same(want, got):
    assert np.array_equal(got.kmer.numpy(), convert.lanes_to_key(want.kmer_hi, want.kmer_lo))
    for f in ("n_distinct", "n_kept", "group_size", "partitions"):
        assert getattr(got, f) == getattr(want, f), f
    assert want.batch_overflows == 0 and not want.kept_overflow
    assert got.n_kept > 1000


@pytest.mark.parametrize("kw,passes", [
    (dict(partitions=4, group_budget_bytes=150_000, expand_slots_budget=1000), (4, 4)),
    (dict(partitions=6, group_budget_bytes=900_000, expand_slots_budget=1000), (2, 5)),
    (dict(partitions=0, group_budget_bytes=2_000_000, expand_slots_budget=250_000), (1, 3)),
], ids=["one_a_group", "ragged", "auto_partitions"])
def test_partitioned_count_super_matches_jax(monkeypatch, kw, passes):
    """Default ragged groups: one partition a pass, groups of unequal
    width, and partitions sized from the expansion budget."""
    want, got = _super_both(monkeypatch, _batches(), cutoff=1, **kw)
    _same(want, got)
    assert passes[0] <= got.passes <= passes[1] and got.expand_chunks >= got.partitions


def test_partitioned_count_super_self_heals_in_the_jax_order(monkeypatch, caplog):
    """Batch 0's reads are short, so the caps drawn from its histogram are
    far below the later batches' loads: partitions overflow and are
    re-extracted alone after their group's clean ones, in both packages."""
    with caplog.at_level("WARNING"):
        want, got = _super_both(monkeypatch, _batches(probe_len=30), partitions=5, cutoff=1,
                                group_budget_bytes=1_000_000, expand_slots_budget=1000)
    _same(want, got)
    assert any(r.name == tooc.__name__ and "super count partition" in r.message
               for r in caplog.records)


def test_partitioned_count_super_subranges_match_jax(monkeypatch):
    """SUB_COUNT_SLOTS patched in both packages to just above one chunk's
    expansion: partitions of two or more occupied chunks are counted by
    key-hash subranges, the others whole -- the same partitions in both,
    so the keys agree in order."""
    for module in (jooc, tooc):
        monkeypatch.setattr(module, "SUB_COUNT_SLOTS", 150_000)
    sub_calls = []
    real = tooc._count_super_partition_subranges
    monkeypatch.setattr(tooc, "_count_super_partition_subranges",
                        lambda *a, **kw: (sub_calls.append(kw["n_chunks"]), real(*a, **kw))[1])
    want, got = _super_both(monkeypatch, _batches(), partitions=6, cutoff=1,
                            expand_chunk=4096, group_budget_bytes=2_000_000,
                            expand_slots_budget=1000)
    _same(want, got)
    assert 0 < len(sub_calls) < got.partitions and all(n >= 2 for n in sub_calls)
    # a subrange-counted partition's keys are not sorted as a whole
    assert not bool((got.kmer[1:] >= got.kmer[:-1]).all())


def test_partitioned_count_super_workers_and_merge(monkeypatch, tmp_path):
    """Two only_partitions workers into one directory, then a merge with no
    re-scan: equal to the JAX package's fresh count; the port's merge of
    JAX-written parts and the JAX merge of port-written parts too."""
    batches = _batches()
    fresh, _ = _super_both(monkeypatch, batches, partitions=5, cutoff=1,
                           group_budget_bytes=900_000, expand_slots_budget=1000)
    kw = dict(partitions=5, cutoff=1, group_budget_bytes=900_000)
    jkw = dict(kw, expand_slots_budget=1000, expand_chunk=1024)
    tb = [tsk.super_records(torch.from_numpy(c), torch.from_numpy(l), k=K, m=M)
          for c, l in batches]
    jb = [jsk.super_records(jnp.asarray(c), jnp.asarray(l), k=K, m=M) for c, l in batches]
    made = []

    def port_batch(b):
        made.append(b)
        return tb[b]
    for writer, merger in (("port", "port"), ("jax", "port"), ("port", "jax")):
        ck = str(tmp_path / f"{writer}_{merger}")
        for rng_ in ((0, 2), (2, 5)):
            if writer == "port":
                tooc.partitioned_count_super(port_batch, 4, k=K, m=M, checkpoint_dir=ck,
                                             only_partitions=rng_, dataset_tag="t", **kw)
            else:
                jooc.partitioned_count_super(lambda b: jb[b], 4, k=K, m=M, kept_cap=1 << 22,
                                             checkpoint_dir=ck, only_partitions=rng_,
                                             dataset_tag="t", **jkw)
        made.clear()
        if merger == "port":
            merged = tooc.partitioned_count_super(port_batch, 4, k=K, m=M, checkpoint_dir=ck,
                                                  dataset_tag="t", **kw)
            assert made == [0] and merged.passes == 0  # the probe alone
            key = merged.kmer.numpy()
        else:
            merged = jooc.partitioned_count_super(lambda b: jb[b], 4, k=K, m=M,
                                                  kept_cap=1 << 22, checkpoint_dir=ck,
                                                  dataset_tag="t", **jkw)
            key = convert.lanes_to_key(merged.kmer_hi, merged.kmer_lo)
        assert np.array_equal(key, convert.lanes_to_key(fresh.kmer_hi, fresh.kmer_lo)), \
            (writer, merger)
        assert merged.n_kept == fresh.n_kept and merged.n_distinct == fresh.n_distinct


def test_partitioned_count_super_refuses_a_foreign_directory(monkeypatch, tmp_path):
    batches = _batches(n_batches=2)
    tb = [tsk.super_records(torch.from_numpy(c), torch.from_numpy(l), k=K, m=M)
          for c, l in batches]
    _expand(monkeypatch, 1000, 1024)
    kw = dict(partitions=3, cutoff=1)
    tooc.partitioned_count_super(lambda b: tb[b], 2, k=K, m=M, checkpoint_dir=str(tmp_path),
                                 dataset_tag="vg-ctr-seed0", **kw)
    with pytest.raises(ValueError, match="different configuration"):
        tooc.partitioned_count_super(lambda b: tb[b], 2, k=K, m=M,
                                     checkpoint_dir=str(tmp_path),
                                     dataset_tag="gen-ctr-seed0", **kw)
    with pytest.raises(ValueError, match="owns nothing"):
        tooc.partitioned_count_super(lambda b: tb[b], 2, k=K, m=M,
                                     checkpoint_dir=str(tmp_path),
                                     dataset_tag="vg-ctr-seed0", only_partitions=(3, 9), **kw)
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        tooc.partitioned_count_super(lambda b: tb[b], 2, k=K, m=M, only_partitions=(0, 1), **kw)

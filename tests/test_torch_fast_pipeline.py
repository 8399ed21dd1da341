"""Port vs JAX package: the fast-mode in-core slice as a whole (CPU).

The four in-core inputs of tests/test_fast_pipeline.py, a read set whose
graph holds cycles and hairpins, and 150-bp reads in rows of 256 bases go
through the JAX ``FastAssembler`` and the port's (``device="cpu"``): the
unitig list (same strings, same ORDER), the coverage arrays, the
per-unitig read-id arrays and the ``PhaseStats`` counters must be equal.
Strings and integers: tolerance 0.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from genome_assembly_tpu.config import PipelineConfig as JConfig
from genome_assembly_tpu.io import datagen as jdatagen
from genome_assembly_tpu.models.pipeline import FastAssembler as JFast
from genome_assembly_tpu_torch.config import PipelineConfig as TConfig
from genome_assembly_tpu_torch.io import datagen as tdatagen
from genome_assembly_tpu_torch.io import reads as treads
from genome_assembly_tpu_torch.models.pipeline import FastAssembler as TFast
from genome_assembly_tpu_torch.ops import bitonic_sort

_RC = str.maketrans("ACGT", "TGCA")


def _rc(s):
    return s.translate(_RC)[::-1]


@functools.lru_cache(maxsize=None)
def _case(name):
    """(reads, config kwargs) of one input of tests/test_fast_pipeline.py."""
    if name == "brute_force_k11":
        _, reads, _ = jdatagen.generate_coverage_reads(
            genome_len=1500, read_len=60, coverage=10, seed=5, with_reverse=True)
        return reads, dict(k=11, m=5, parity=False, max_read_len=64, batch_reads=512)
    if name == "clean_genome_k21":
        _, reads, _ = jdatagen.generate_coverage_reads(
            genome_len=800, read_len=80, coverage=15, seed=11, with_reverse=True)
        return reads, dict(k=21, m=7, parity=False, max_read_len=96, batch_reads=256)
    if name == "long_sequence_k15":
        rng = np.random.default_rng(21)
        genome = "".join(rng.choice(list("ACGT"), size=5000))
        kw = dict(k=15, m=7, parity=False, abundance_cutoff=0,
                  max_read_len=128, batch_reads=256)
        return treads.chunk_long_sequence(genome, 128, 15), kw
    if name == "strand_invariance_k13":
        _, reads, _ = jdatagen.generate_coverage_reads(
            genome_len=600, read_len=50, coverage=8, seed=3)
        # several batches, the last one padded
        return reads, dict(k=13, m=5, parity=False, max_read_len=64, batch_reads=32)
    if name == "strand_invariance_k13_rc":
        reads, kw = _case("strand_invariance_k13")
        return [_rc(r) for r in reads], kw
    if name == "cycles_hairpins_k7":
        # tandem repeats (cycles), a read followed by its reverse complement
        # (hairpins: the link join drops the edge from a state to its own
        # twin), a palindromic (k-1)-mer junction (GGATCC) and a random read;
        # every k-mer kept, several batches
        rng = np.random.default_rng(41)

        def dna(n):
            return "".join(rng.choice(list("ACGT"), size=n))
        hairpin = dna(40)
        reads = [dna(12) * 6, dna(9) * 5, hairpin + _rc(hairpin),
                 hairpin + "A" + _rc(hairpin), "ACGTGCAATCGGATCCA", dna(90)]
        return reads, dict(k=7, m=3, parity=False, abundance_cutoff=0, max_read_len=128,
                           batch_reads=4)
    if name == "reads_150bp_k31":
        # 150-bp reads in rows of 256 bases (the scan's two rounds of 128),
        # several batches, the last one padded
        _, reads, _ = jdatagen.generate_coverage_reads(
            genome_len=2000, read_len=150, coverage=12, seed=17, with_reverse=True)
        return reads, dict(k=31, m=4, parity=False, max_read_len=256, batch_reads=64)
    raise KeyError(name)


CASES = ["brute_force_k11", "clean_genome_k21", "long_sequence_k15",
         "strand_invariance_k13", "strand_invariance_k13_rc", "cycles_hairpins_k7",
         "reads_150bp_k31"]


def _counters(stats):
    """The counters both packages keep (the JAX ``PhaseStats`` has no
    ``spans_s`` or ``counts``)."""
    d = dataclasses.asdict(stats)
    for clock_reading in ("wall_s", "spans_s", "counts"):
        d.pop(clock_reading, None)
    return d


def _pair(name):
    reads, kw = _case(name)
    return reads, JFast(JConfig(**kw)), TFast(TConfig(**kw), device="cpu")


@pytest.mark.parametrize("name", CASES)
def test_unitigs_match_jax(name):
    reads, jasm, tasm = _pair(name)
    want, wstats = jasm.unitigs(reads)
    got, gstats = tasm.unitigs(reads)
    assert got == want
    assert _counters(gstats) == _counters(wstats)
    assert got, "empty assembly proves nothing"
    assert set(gstats.wall_s) == {"batch", "scan", "count", "links", "jump", "materialize"}


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("method", ["unitigs", "unitigs_with_coverage"])
def test_hybrid_sort_unitigs_match_jax(monkeypatch, name, method):
    """``hybrid_sort=True`` with the chunk defaults shrunk so the network runs
    at toy size: the JAX unitigs in the same order, same counters."""
    monkeypatch.setattr(bitonic_sort, "DEFAULT_LIB_CHUNK", 256)
    monkeypatch.setattr(bitonic_sort, "DEFAULT_CHUNK", 32)
    passes = []
    real = bitonic_sort.finish_plain
    monkeypatch.setattr(bitonic_sort, "finish_plain",
                        lambda *a, **kw: (passes.append(1), real(*a, **kw))[1])
    reads, kw = _case(name)
    want = getattr(JFast(JConfig(**kw, pallas_sort=True)), method)(reads)
    got = getattr(TFast(TConfig(**kw, hybrid_sort=True), device="cpu"), method)(reads)
    assert passes, "the sort took the library route: the network was not driven"
    assert got[0] == want[0] and got[0]
    for g, w in zip(got[1:-1], want[1:-1]):
        assert np.array_equal(g, w) and g.dtype == w.dtype
    assert _counters(got[-1]) == _counters(want[-1])
    passes.clear()
    default = getattr(TFast(TConfig(**kw), device="cpu"), method)(reads)
    assert not passes and default[0] == got[0]


def test_unitigs_from_sequences_match_jax():
    rng = np.random.default_rng(21)
    genome = "".join(rng.choice(list("ACGT"), size=5000))
    _, kw = _case("long_sequence_k15")
    seqs = [genome, genome[100:180], "ACGT"]
    want, wstats = JFast(JConfig(**kw)).unitigs_from_sequences(seqs)
    got, gstats = TFast(TConfig(**kw), device="cpu").unitigs_from_sequences(seqs)
    assert got == want
    assert _counters(gstats) == _counters(wstats)
    assert gstats.n_windows >= len(genome) - kw["k"] + 1


@pytest.mark.parametrize("name", CASES)
def test_unitigs_with_coverage_match_jax(name):
    reads, jasm, tasm = _pair(name)
    want, w_sum, w_n, wstats = jasm.unitigs_with_coverage(reads)
    got, g_sum, g_n, gstats = tasm.unitigs_with_coverage(reads)
    assert got == want
    assert np.array_equal(g_sum, w_sum) and g_sum.dtype == w_sum.dtype
    assert np.array_equal(g_n, w_n) and g_n.dtype == w_n.dtype
    assert _counters(gstats) == _counters(wstats)


@pytest.mark.parametrize("name", CASES)
def test_unitigs_with_read_ids_match_jax(name):
    reads, jasm, tasm = _pair(name)
    want, w_ids, wstats = jasm.unitigs_with_read_ids(reads)
    got, g_ids, gstats = tasm.unitigs_with_read_ids(reads)
    assert got == want
    assert len(g_ids) == len(w_ids)
    for g, w in zip(g_ids, w_ids):
        assert np.array_equal(g, w) and g.dtype == w.dtype
    assert _counters(gstats) == _counters(wstats)


def test_strand_invariance_of_the_port():
    reads, kw = _case("strand_invariance_k13")
    u1, _ = TFast(TConfig(**kw), device="cpu").unitigs(reads)
    u2, _ = TFast(TConfig(**kw), device="cpu").unitigs([_rc(r) for r in reads])
    assert sorted(min(u, _rc(u)) for u in u1) == sorted(min(u, _rc(u)) for u in u2)


def test_everything_pruned_gives_no_unitigs():
    reads, kw = _case("strand_invariance_k13")
    kw = dict(kw, abundance_cutoff=100)
    want, wstats = JFast(JConfig(**kw)).unitigs(reads)
    got, gstats = TFast(TConfig(**kw), device="cpu").unitigs(reads)
    assert got == want == []
    assert _counters(gstats) == _counters(wstats)


# tests/test_fast_pipeline.py's two out-of-core configurations: a tiny
# outofcore_bytes alone (partitioned count, in-core join and jump), then with
# the link budget and jump limit too (out-of-core links, bulk jump); and the
# 150-bp reads of CASES past a limit that gives them 4 partitions
OOC_LIMITS = {
    "count": dict(outofcore_bytes=1 << 12),
    "count_links_jump": dict(outofcore_bytes=1 << 12, link_budget_bytes=1 << 10,
                             bulk_jump_states=8),
    "count_150bp": dict(outofcore_bytes=1 << 18),
}


def _ooc_reads(seed):
    if isinstance(seed, str):
        return _case(seed)
    _, reads, _ = jdatagen.generate_coverage_reads(
        genome_len=900, read_len=48, coverage=8, seed=seed, with_reverse=True)
    return reads, dict(k=11, m=5, parity=False, max_read_len=64, batch_reads=128)


@pytest.mark.parametrize("limits,seed", [("count", 29), ("count_links_jump", 31),
                                         ("count_150bp", "reads_150bp_k31")])
def test_outofcore_unitigs_match_jax_in_order(limits, seed):
    """Past outofcore_bytes the port returns the JAX package's out-of-core
    list -- same strings, same ORDER (partition, then key, then the
    self-heal order) -- with the same counters; the in-core run gives the
    same unitig set."""
    reads, kw = _ooc_reads(seed)
    ooc = dict(kw, **OOC_LIMITS[limits])
    want, wstats = JFast(JConfig(**ooc)).unitigs(reads)
    got, gstats = TFast(TConfig(**ooc), device="cpu").unitigs(reads)
    assert got == want and got
    assert _counters(gstats) == _counters(wstats)
    assert set(gstats.wall_s) == {"batch", "count", "links", "jump", "materialize"}
    assert gstats.counts["partitions"] > 1
    incore, istats = TFast(TConfig(**kw), device="cpu").unitigs(reads)
    assert sorted(incore) == sorted(got)
    assert (istats.entries_pre_prune, istats.entries_post_prune) == (
        gstats.entries_pre_prune, gstats.entries_post_prune)


def _spy(monkeypatch, calls, *names):
    """Wrap ``dbg``'s functions ``names`` to append their name to ``calls``."""
    from genome_assembly_tpu_torch.ops import dbg as tdbg

    for name in names:
        real = getattr(tdbg, name)
        monkeypatch.setattr(tdbg, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])


def test_outofcore_switches_reach_every_branch(monkeypatch):
    """The second configuration really builds its links out of core and
    jumps with the bulk form; the first keeps the in-core join and jump."""
    calls = []
    _spy(monkeypatch, calls, "build_unitig_links_join", "build_unitig_links_ooc",
         "pointer_jump", "pointer_jump_bulk", "materialize_unitigs_device")
    for limits, seed in (("count", 29), ("count_links_jump", 31)):
        reads, kw = _ooc_reads(seed)
        calls.clear()
        TFast(TConfig(**dict(kw, **OOC_LIMITS[limits])), device="cpu").unitigs(reads)
        if limits == "count":
            assert calls == ["build_unitig_links_join", "pointer_jump",
                             "materialize_unitigs_device"]
        else:
            assert calls == ["build_unitig_links_ooc", "pointer_jump_bulk",
                             "materialize_unitigs_device"]


# -- the in-core materializer: the device walk sort, the host one past its limit --

@pytest.mark.parametrize("method", ["unitigs", "unitigs_with_coverage"])
def test_incore_materializes_with_the_device_walk_sort(monkeypatch, method):
    """In core the graph is built by the join and the fused jump, then
    materialized by the device walk sort; the host materializer never runs,
    and the run's counter ``on_device`` is 1."""
    calls = []
    _spy(monkeypatch, calls, "build_unitig_links_join", "build_unitig_links_ooc",
         "pointer_jump", "pointer_jump_bulk", "materialize_unitigs_device",
         "materialize_unitigs", "materialize_unitigs_cov")
    reads, kw = _case("clean_genome_k21")
    got = getattr(TFast(TConfig(**kw), device="cpu"), method)(reads)
    assert calls == ["build_unitig_links_join", "pointer_jump", "materialize_unitigs_device"]
    assert got[0] and got[-1].counts["on_device"] == 1


@pytest.mark.parametrize("name", CASES)
def test_past_the_walk_sort_limit_the_host_materializes_the_same(monkeypatch, name):
    """With ``dbg.MAX_WALK_STATES`` below the graph's states both in-core
    routes fall back to the host materializer, counted as ``on_device`` 0:
    the same list in the same order, and the same coverage arrays."""
    from genome_assembly_tpu_torch.ops import dbg as tdbg

    reads, kw = _case(name)
    asm = TFast(TConfig(**kw), device="cpu")
    device = asm.unitigs(reads)
    device_cov = asm.unitigs_with_coverage(reads)
    calls = []
    _spy(monkeypatch, calls, "materialize_unitigs_device", "materialize_unitigs",
         "materialize_unitigs_cov")
    monkeypatch.setattr(tdbg, "MAX_WALK_STATES", 2 * device[1].entries_post_prune - 1)
    host = asm.unitigs(reads)
    host_cov = asm.unitigs_with_coverage(reads)
    assert calls == ["materialize_unitigs", "materialize_unitigs_cov"]
    assert host[0] == device[0] == device_cov[0] == host_cov[0] and host[0]
    for h, d in zip(host_cov[1:3], device_cov[1:3]):
        assert np.array_equal(h, d) and h.dtype == d.dtype == np.int64
    assert device[1].counts["on_device"] == device_cov[-1].counts["on_device"] == 1
    assert host[1].counts["on_device"] == host_cov[-1].counts["on_device"] == 0
    assert _counters(host[1]) == _counters(device[1])


def test_the_cycles_case_holds_cycles_hairpins_and_a_palindromic_junction(monkeypatch):
    """The graph of ``cycles_hairpins_k7``, whose in-core lists the tests
    above hold to the JAX package's in order, has cycles, and its reads a
    hairpin (a palindromic (k+1)-mer) and a palindromic (k-1)-mer.  No
    unitig is its own reverse complement at odd k: its middle (k+1)-mer
    would be such a hairpin edge."""
    from genome_assembly_tpu_torch.ops import dbg as tdbg

    graphs = []
    real = tdbg.pointer_jump
    monkeypatch.setattr(tdbg, "pointer_jump",
                        lambda *a, **k: (lambda g: (graphs.append(g), g)[1])(real(*a, **k)))
    reads, kw = _case("cycles_hairpins_k7")
    out, stats = TFast(TConfig(**kw), device="cpu").unitigs(reads)
    (graph,) = graphs
    assert bool(graph.is_cycle.any()) and stats.counts["on_device"] == 1
    assert out and not any(u == _rc(u) for u in out)
    k = kw["k"]
    for width in (k + 1, k - 1):
        assert any(r[i:i + width] == _rc(r[i:i + width])
                   for r in reads for i in range(len(r) - width + 1))


def test_a_traced_incore_run_marks_the_device_materializer(tmp_path):
    """The trace of an in-core run holds ``materialize.on_device=1`` and the
    six steps of the materializer, each inside the phase."""
    import json
    import pathlib

    from genome_assembly_tpu_torch.utils import profiling

    reads, kw = _case("clean_genome_k21")
    with profiling.maybe_trace(str(tmp_path)):
        TFast(TConfig(**kw), device="cpu").unitigs(reads)
    (path,) = pathlib.Path(tmp_path).glob("*.json")
    ranges = [(e["name"], e["ts"], e["ts"] + e["dur"])
              for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"]
    (phase,) = [r for r in ranges if r[0] == "materialize"]
    inside = {n for n, a, b in ranges if n.startswith("materialize.")
              and phase[1] <= a and b <= phase[2]}
    steps = ("readback", "revcomp", "cycles", "sort", "spell", "strands")
    assert {n for n in inside if "=" not in n} == {f"materialize.{s}" for s in steps}
    assert "materialize.on_device=1" in inside


def test_outofcore_hybrid_sort_matches_jax(monkeypatch):
    """hybrid_sort past outofcore_bytes: the partition counts drive the
    network (chunk defaults shrunk), the list equals the JAX package's."""
    monkeypatch.setattr(bitonic_sort, "DEFAULT_LIB_CHUNK", 256)
    monkeypatch.setattr(bitonic_sort, "DEFAULT_CHUNK", 32)
    passes = []
    real = bitonic_sort.finish_plain
    monkeypatch.setattr(bitonic_sort, "finish_plain",
                        lambda *a, **kw: (passes.append(1), real(*a, **kw))[1])
    reads, kw = _ooc_reads(29)
    ooc = dict(kw, outofcore_bytes=1 << 14)
    want, wstats = JFast(JConfig(**ooc, pallas_sort=True)).unitigs(reads)
    got, gstats = TFast(TConfig(**ooc, hybrid_sort=True), device="cpu").unitigs(reads)
    assert passes, "the partition counts took the library route"
    assert got == want and _counters(gstats) == _counters(wstats)


def test_outofcore_everything_pruned_matches_jax():
    reads, kw = _ooc_reads(29)
    ooc = dict(kw, abundance_cutoff=100, **OOC_LIMITS["count_links_jump"])
    want, wstats = JFast(JConfig(**ooc)).unitigs(reads)
    got, gstats = TFast(TConfig(**ooc), device="cpu").unitigs(reads)
    assert got == want == []
    assert _counters(gstats) == _counters(wstats)
    assert gstats.entries_pre_prune > 0 and gstats.entries_post_prune == 0


@pytest.mark.parametrize(
    "method", ["unitigs", "unitigs_with_coverage", "unitigs_with_read_ids"])
def test_mesh_branch_waits(method):
    """The mesh branch runs (a CPU mesh of 4 shards gives the single-device
    unitigs); the two-level routing, which no pipeline calls, counts the
    same reads over a (2, 2) mesh as the flat router does, row for row."""
    from genome_assembly_tpu_torch.io import reads as treads
    from genome_assembly_tpu_torch.parallel import mesh as tmesh
    from genome_assembly_tpu_torch.parallel import shard_count

    reads, kw = _case("brute_force_k11")
    asm = TFast(TConfig(**kw), device="cpu")
    mesh = tmesh.make_mesh(4, devices=["cpu"])
    assert sorted(getattr(asm, method)(reads, mesh=mesh)[0]) == sorted(
        getattr(asm, method)(reads)[0])
    (b,) = treads.batch_reads(reads[:8], kw["max_read_len"])
    count = dict(k=kw["k"], m=kw["m"], parity=False, cutoff=1)
    flat = shard_count.sharded_count(b.codes, b.lengths, b.read_ids, mesh=mesh, **count)
    two = shard_count.sharded_count(b.codes, b.lengths, b.read_ids, routing="two_level",
                                    mesh=tmesh.make_mesh(devices=["cpu"], shape=(2, 2)),
                                    **count)
    for name in shard_count.ShardedCount._fields:
        assert all(torch.equal(x, y) for x, y in zip(getattr(flat, name), getattr(two, name)))


def test_constructor_checks_match_jax():
    for kw in (dict(k=12, m=5, parity=False), dict(k=11, m=5, parity=True)):
        with pytest.raises(ValueError):
            JFast(JConfig(**kw))
        with pytest.raises(ValueError):
            TFast(TConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="no reads"):
        TFast(TConfig(k=11, m=5, parity=False), device="cpu").unitigs([])


@pytest.mark.parametrize(
    "bad", [dict(m=16), dict(k=32), dict(k=5, m=7, parity=False), dict(k=9, m=5),
            dict(abundance_cutoff=-1), dict(max_read_len=8), dict(wide_state_ids="x")])
def test_config_checks_match_jax(bad):
    with pytest.raises(ValueError):
        JConfig(**bad)
    with pytest.raises(ValueError):
        TConfig(**bad)


def test_config_fields_match_jax_minus_pallas_switches():
    jf = {f.name: f.default for f in dataclasses.fields(JConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(TConfig)}
    assert set(jf) - set(tf) == {"pallas_scan", "pallas_sort"}
    # the one field with another name: hybrid_sort is the port's pallas_sort
    assert set(tf) - set(jf) == {"hybrid_sort"}
    assert tf.pop("hybrid_sort") is False and jf["pallas_sort"] is False
    assert all(tf[n] == jf[n] for n in tf)
    c = TConfig(k=21, m=7)
    j = JConfig(k=21, m=7)
    assert (c.windows_per_read, c.mmer_mask, c.kmer_split()) == (
        j.windows_per_read, j.mmer_mask, j.kmer_split())


def test_host_io_copies_match_jax(tmp_path):
    from genome_assembly_tpu.io import reads as jreads

    genome, reads, starts = tdatagen.generate_coverage_reads(
        genome_len=300, read_len=40, coverage=4, seed=9, error_rate=0.05, with_reverse=True)
    assert (genome, reads, starts) == jdatagen.generate_coverage_reads(
        genome_len=300, read_len=40, coverage=4, seed=9, error_rate=0.05, with_reverse=True)
    reads = reads + ["", "acgtn", "N" * 40]
    for parity_chars in (False, True):
        want = jreads.batch_reads(reads, 48, 7, start_id=3, parity_chars=parity_chars)
        got = treads.batch_reads(reads, 48, 7, start_id=3, parity_chars=parity_chars)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for f in ("codes", "lengths", "read_ids"):
                a, b = getattr(g, f), getattr(w, f)
                assert a.dtype == b.dtype and np.array_equal(a, b)
    gp, wp = treads.pad_batch(got[-1], 7), jreads.pad_batch(want[-1], 7)
    assert all(np.array_equal(getattr(gp, f), getattr(wp, f))
               for f in ("codes", "lengths", "read_ids"))
    assert treads.chunk_long_sequence(genome, 64, 21) == jreads.chunk_long_sequence(genome, 64, 21)
    path = tmp_path / "r.fa"
    path.write_text(">a\nACGT\nTTGA\n\n>b\nGGGA\n")
    assert treads.load_fasta(str(path)) == jreads.load_fasta(str(path)) == ["ACGTTTGA", "GGGA"]
    assert treads.load_reads_fast(str(path)) == jreads.load_reads_fast(str(path))
    tdatagen.write_reads(["AC", "GT"], str(tmp_path / "w.txt"))
    assert (tmp_path / "w.txt").read_text() == "AC\nGT\n"
    with pytest.raises(ValueError):
        treads.batch_reads(["A" * 50], 48)


@pytest.mark.parametrize("name,batch_reads", [("strand_invariance_k13", 28),
                                              ("long_sequence_k15", 16)])
def test_scan_counts_windows_with_one_read_back(monkeypatch, name, batch_reads):
    """Several batches, the last one ragged and padded: ``n_windows`` equals
    the JAX pipeline's count and the sum of ``valid`` over the records, and
    the scan phase turns a tensor into a host int once, after its last batch."""
    import torch

    from genome_assembly_tpu_torch.models.pipeline import PhaseStats

    reads, kw = _case(name)
    kw = dict(kw, batch_reads=batch_reads)
    cfg = TConfig(**kw)
    batches = treads.batch_reads(reads, cfg.max_read_len, cfg.batch_reads)
    assert len(batches) > 2 and len(batches[-1].codes) < cfg.batch_reads
    _, wstats = JFast(JConfig(**kw)).unitigs(reads)
    to_int = []
    real = torch.Tensor.__int__
    monkeypatch.setattr(torch.Tensor, "__int__", lambda t: (to_int.append(1), real(t))[1])

    class Clock:
        def start(self, name):
            pass

        def stop(self):
            pass

    stats = PhaseStats()
    recs, _ = TFast(cfg, device="cpu")._flat_fast_records(reads, stats, Clock())
    assert len(to_int) == 1
    monkeypatch.setattr(torch.Tensor, "__int__", real)
    assert stats.n_windows == wstats.n_windows == int(recs.valid.sum())
    assert stats.n_windows > 0

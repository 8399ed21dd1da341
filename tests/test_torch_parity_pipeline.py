"""Parity mode as a whole: the port's ``ParityAssembler`` (CPU) against the
JAX package's and against the ``input_k6m3_*`` goldens.

``tests/golden/input.txt`` is the 20-read input of those goldens, rebuilt
from ``input_k6m3_preprune.txt``: every read id's windows are stored
k-mers of that table or their complements, and each id has exactly two
solutions, a read and its whole-read complement, which the parity scan
gives identical records.  The JAX ``ParityAssembler`` reproduces all four
goldens from it (tested here, both engines), so the file is the goldens'
input.

The rest feeds the same reads -- the fixture, generated multi-batch read
sets (100-bp lines through the ``fgets`` quirk included) and the non-ACGT
fixtures of tests/test_parity_nonacgt.py -- to both packages' assemblers
and requires equal unitig lines (same order), verbose text, tables and
``PhaseStats`` counters.  Strings and integers: tolerance 0.
"""

import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from genome_assembly_tpu.config import PipelineConfig as JConfig
from genome_assembly_tpu.io import datagen as jdatagen
from genome_assembly_tpu.models.pipeline import CountPipeline as JCount
from genome_assembly_tpu.models.pipeline import ParityAssembler as JParity
from genome_assembly_tpu.parity import table as jtable
from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.config import PipelineConfig as TConfig
from genome_assembly_tpu_torch.io import datagen as tdatagen
from genome_assembly_tpu_torch.models.pipeline import CountPipeline as TCount
from genome_assembly_tpu_torch.models.pipeline import ParityAssembler as TParity
from genome_assembly_tpu_torch.parity import model
from genome_assembly_tpu_torch.parity import table as ttable

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO_ROOT / "tests" / "golden"
FIXTURE = GOLDEN / "input.txt"
ENGINES = ["python", "native"]
COUNTERS = ("n_reads", "n_windows", "entries_pre_prune", "entries_post_prune")


def _golden_table(name):
    table = {}
    for line in (GOLDEN / name).read_text().splitlines():
        if line:
            mmer, kmer, ids = line.split("\t")
            table[(mmer, kmer)] = [int(x) for x in ids.split(",")] if ids else []
    return table


def _pair(batch_reads=64, **kw):
    kw = {**dict(k=6, m=3, max_read_len=32, batch_reads=batch_reads), **kw}
    return JParity(JConfig(**kw)), TParity(TConfig(**kw), device="cpu")


def _counters(stats):
    return {f: getattr(stats, f) for f in COUNTERS}


# -- the fixture and the goldens -------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_jax_reproduces_the_goldens_from_the_rebuilt_fixture(engine):
    asm = JParity(JConfig(k=6, m=3, max_read_len=32, batch_reads=64))
    reads = asm.load(str(FIXTURE))
    assert len(reads) == 20 and sorted(set(map(len, reads))) == [14, 15]
    lines, _ = asm.assemble(reads, engine=engine)
    assert lines == (GOLDEN / "input_k6m3_unitigs.txt").read_text().splitlines()
    assert len(lines) == 61
    text, _ = asm.assemble(reads, engine=engine, verbose=True)
    assert text == (GOLDEN / "input_k6m3_verbose.txt").read_text()
    assert asm.pruned_table_dict(reads) == _golden_table("input_k6m3_postprune.txt")
    _, stats = asm.pruned_table(reads)
    assert (stats.entries_pre_prune, stats.entries_post_prune) == (97, 89)
    # cutoff 0 keeps every group: the pre-prune table
    keep_all = JParity(JConfig(k=6, m=3, max_read_len=32, batch_reads=64, abundance_cutoff=0))
    assert keep_all.pruned_table_dict(reads) == _golden_table("input_k6m3_preprune.txt")


def test_fixture_tiles_the_preprune_table():
    """Every window of the fixture is a row of the pre-prune golden, with
    the read's id among that row's ids, and every row is covered."""
    reads = TParity(TConfig(k=6, m=3), device="cpu").load(str(FIXTURE))
    pre = _golden_table("input_k6m3_preprune.txt")
    spec = model.count_table(model.scan_reads(reads, 6, 3), -1)
    assert spec == pre
    assert len(pre) == 97


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("batch_reads", [64, 7])
def test_port_reproduces_the_goldens(engine, batch_reads):
    asm = TParity(TConfig(k=6, m=3, max_read_len=32, batch_reads=batch_reads), device="cpu")
    reads = asm.load(str(FIXTURE))
    lines, stats = asm.assemble(reads, engine=engine)
    assert lines == (GOLDEN / "input_k6m3_unitigs.txt").read_text().splitlines()
    assert (stats.entries_pre_prune, stats.entries_post_prune,
            stats.entries_post_extension) == (97, 89, 61)
    assert set(stats.wall_s) == {"batch", "scan", "count", "extract", "replay"}
    text, vstats = asm.assemble(reads, engine=engine, verbose=True)
    assert text == (GOLDEN / "input_k6m3_verbose.txt").read_text()
    assert vstats.entries_post_extension == 0
    assert asm.pruned_table_dict(reads) == _golden_table("input_k6m3_postprune.txt")
    host, stats = asm.pruned_table(reads)
    assert (stats.entries_pre_prune, stats.entries_post_prune) == (97, 89)
    assert len(host.mmer) == 89
    keep_all = TParity(TConfig(k=6, m=3, max_read_len=32, batch_reads=batch_reads,
                               abundance_cutoff=0), device="cpu")
    assert keep_all.pruned_table_dict(reads) == _golden_table("input_k6m3_preprune.txt")


def test_fixture_tables_and_expanded_table_match_jax():
    jasm, tasm = _pair()
    reads = tasm.load(str(FIXTURE))
    jhost, jstats = jasm.pruned_table(reads)
    thost, tstats = tasm.pruned_table(reads)
    assert _counters(tstats) == _counters(jstats)
    got = convert.host_table_to_lanes(thost)
    for ours, theirs in zip(got[:5], jhost[:5]):
        np.testing.assert_array_equal(ours, theirs)
    assert [list(r) for r in got[5]] == [list(r) for r in jhost.read_ids]
    assert ttable.decode_table(thost, 6, 3) == jtable.decode_table(jhost, 6, 3)
    want = jasm.expanded_table(reads, engine="native")
    for engine in ENGINES:
        assert tasm.expanded_table(reads, engine=engine) == want
    assert tasm.expanded_table(reads, engine="auto") == want
    groups = tasm.pruned_table_groups(reads)
    assert [(s, k, list(i)) for s, k, i in groups] == [
        (s, k, list(i)) for s, k, i in jasm.pruned_table_groups(reads)]


# -- generated read sets, several batches ----------------------------------

@functools.lru_cache(maxsize=None)
def _generated(kind):
    if kind == "coverage":
        # the shape of the non-ACGT fixture at batch 16: five batches
        # whose merge the JAX package compiles once for both
        _, reads, _ = jdatagen.generate_coverage_reads(
            genome_len=400, read_len=30, coverage=6, seed=9, with_reverse=False)
        return tuple(reads), dict(k=6, m=3, max_read_len=32, batch_reads=16)
    # 100-bp lines through fgets(101): 99-bp reads and empty ones
    _, reads, _ = jdatagen.generate_coverage_reads(
        genome_len=1500, read_len=100, coverage=8, seed=3, with_reverse=True)
    return tuple(reads), dict(k=31, m=4, max_read_len=128, batch_reads=64)


@pytest.mark.parametrize("kind", ["coverage", "fgets_k31"])
def test_generated_reads_match_jax_with_both_engines(kind, tmp_path):
    reads, kw = _generated(kind)
    path = tmp_path / "reads.txt"
    tdatagen.write_reads(list(reads), str(path))
    jasm, tasm = _pair(**kw)
    loaded = tasm.load(str(path))
    assert loaded == jasm.load(str(path))
    if kind == "fgets_k31":
        assert len(loaded) == 2 * len(reads) and set(map(len, loaded)) == {0, 99}
    assert -(-len(loaded) // kw["batch_reads"]) >= 3
    want, jstats = jasm.assemble(loaded, engine="native")
    want_v, _ = jasm.assemble(loaded, engine="native", verbose=True)
    assert len(want) > 10
    for engine in ENGINES:
        got, tstats = tasm.assemble(loaded, engine=engine)
        assert got == want
        assert _counters(tstats) == _counters(jstats)
        assert tstats.entries_post_extension == len(want)
        got_v, _ = tasm.assemble(loaded, engine=engine, verbose=True)
        assert got_v == want_v
    assert tasm.pruned_table_dict(loaded) == jasm.pruned_table_dict(loaded)


def test_port_datagen_matches_jax():
    kw = dict(genome_len=600, read_len=30, coverage=6, seed=9, with_reverse=True)
    assert tdatagen.generate_coverage_reads(**kw) == jdatagen.generate_coverage_reads(**kw)


def test_count_reads_matches_jax():
    reads, kw = _generated("coverage")
    jcounted, jstats = JCount(JConfig(**kw)).count_reads(list(reads), start_id=3)
    tcounted, tstats = TCount(TConfig(**kw), device="cpu").count_reads(list(reads), start_id=3)
    assert _counters(tstats) == _counters(jstats)
    assert set(tstats.wall_s) == {"batch", "scan", "count"}
    ours = convert.counted_table_to_lanes(tcounted)
    n = int(np.asarray(jcounted.valid).sum())
    for a, b in zip(ours, jcounted):
        np.testing.assert_array_equal(a[:n], np.asarray(b)[:n])
    assert ours[5].sum() == n


def test_scan_takes_the_parity_branch():
    reads, kw = _generated("coverage")
    counter = TCount(TConfig(**kw), device="cpu")
    from genome_assembly_tpu_torch.io import reads as treads

    codes, lengths, _ = convert.read_batch_to_torch(
        treads.batch_reads(list(reads[:20]), 32, parity_chars=True)[0])
    recs = counter.scan(codes, lengths)
    jrecs = JCount(JConfig(**kw)).scan(codes.numpy(), lengths.numpy())
    want = convert.window_records_from_lanes(
        np.asarray(jrecs.mmer), np.asarray(jrecs.kmer_hi), np.asarray(jrecs.kmer_lo),
        np.asarray(jrecs.valid))
    for a, b in zip(recs, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# -- non-ACGT reads -----------------------------------------------------------

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


def _lowercase_run_reads():
    """The lowercase-run fixture of tests/test_parity_nonacgt.py (k=21, m=4)."""
    rng = np.random.default_rng(1)
    genome = "".join(rng.choice(list("ACGT"), size=300))
    reads = []
    for _ in range(60):
        p = int(rng.integers(0, len(genome) - 50))
        reads.append(genome[p : p + 50])
    for j in range(0, 60, 7):
        r = reads[j]
        pos = int(rng.integers(0, 30))
        reads[j] = r[:pos] + r[pos : pos + 8].lower() + r[pos + 8 :]
    return reads


@pytest.mark.parametrize("batch_reads", [128, 16])
def test_nonacgt_reads_match_jax_and_the_spec(batch_reads):
    reads = _dirty_reads()
    jasm, tasm = _pair(batch_reads=batch_reads)
    groups = tasm.pruned_table_groups(reads)
    assert [(s, k, list(i)) for s, k, i in groups] == [
        (s, k, list(i)) for s, k, i in jasm.pruned_table_groups(reads)]
    table = tasm.pruned_table_dict(reads)
    assert table == jasm.pruned_table_dict(reads)
    assert table == model.count_table(model.scan_reads(reads, 6, 3), 1)
    assert any(not frozenset("ACGT").issuperset(s + k) for s, k in table)
    want, jstats = jasm.assemble(reads, engine="native")
    assert any(not frozenset("ACGT").issuperset(line) for line in want)
    want_v, _ = jasm.assemble(reads, engine="native", verbose=True)
    for engine in ENGINES:
        got, tstats = tasm.assemble(reads, engine=engine)
        assert got == want
        assert _counters(tstats) == _counters(jstats)
        assert tasm.assemble(reads, engine=engine, verbose=True)[0] == want_v
    assert tasm.expanded_table(reads, engine="native") == jasm.expanded_table(reads, engine="python")
    with pytest.raises(NotImplementedError):
        tasm.pruned_table(reads)


def test_lowercase_runs_match_jax():
    reads = _lowercase_run_reads()
    kw = dict(k=21, m=4, max_read_len=64, batch_reads=64)
    jasm, tasm = JParity(JConfig(**kw)), TParity(TConfig(**kw), device="cpu")
    assert tasm.pruned_table_groups(reads) == jasm.pruned_table_groups(reads)
    assert tasm.assemble(reads, engine="native")[0] == jasm.assemble(reads, engine="native")[0]


def test_clean_reads_through_the_exception_path_are_unchanged():
    from genome_assembly_tpu_torch.native import replay_native

    reads = [r for r in _dirty_reads() if frozenset("ACGT").issuperset(r)]
    _, tasm = _pair()
    clean, _ = tasm.assemble(reads, engine="native")
    groups, _, _ = tasm._nonacgt_groups(reads)
    assert replay_native.assemble_groups(groups, 6, 3, 1) == clean


# -- out of core ------------------------------------------------------------

# (batch_reads, outofcore_bytes) that send the 20-read fixture out of core:
# one batch (6 partitions, 2 passes: the JAX package's own out-of-core
# golden test), and three batches of 7, the last one padded (7 partitions)
OOC_CONFIGS = [(64, 20_000), (7, 5_000)]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("batch_reads,limit", OOC_CONFIGS)
def test_outofcore_reproduces_the_goldens(engine, batch_reads, limit):
    asm = TParity(TConfig(k=6, m=3, max_read_len=32, batch_reads=batch_reads,
                          outofcore_bytes=limit), device="cpu")
    reads = asm.load(str(FIXTURE))
    assert asm._needs_outofcore(reads)
    lines, stats = asm.assemble(reads, engine=engine)
    assert lines == (GOLDEN / "input_k6m3_unitigs.txt").read_text().splitlines()
    # the JAX package's out-of-core counters: every group, none pruned yet
    assert (stats.n_windows, stats.entries_pre_prune, stats.entries_post_prune,
            stats.entries_post_extension) == (199, 97, 0, 61)
    assert set(stats.wall_s) == {"batch", "count", "replay"}
    text, _ = asm.assemble(reads, engine=engine, verbose=True)
    assert text == (GOLDEN / "input_k6m3_verbose.txt").read_text()
    assert asm.pruned_table_dict(reads) == _golden_table("input_k6m3_postprune.txt")


@pytest.mark.parametrize("batch_reads,limit", OOC_CONFIGS)
def test_outofcore_tables_match_jax(batch_reads, limit):
    """The five calls the out-of-core branch serves -- assemble,
    pruned_table, pruned_table_dict on clean reads (the fixture four times
    over), assemble and pruned_table_groups on the non-ACGT reads -- return
    the JAX package's results, counters included."""
    jasm, tasm = _pair(batch_reads=batch_reads, outofcore_bytes=limit)
    reads = tasm.load(str(FIXTURE)) * 4
    dirty = _dirty_reads()
    for r in (reads, dirty):
        assert tasm._needs_outofcore(r) and jasm._needs_outofcore(r)
    for engine in ENGINES:
        got, tstats = tasm.assemble(reads, engine=engine)
        want, jstats = jasm.assemble(reads, engine=engine)
        assert got == want and _counters(tstats) == _counters(jstats)
    thost, tstats = tasm.pruned_table(reads)
    jhost, jstats = jasm.pruned_table(reads)
    assert _counters(tstats) == _counters(jstats)
    ours = convert.host_table_to_lanes(thost)
    for a, b in zip(ours[:5], jhost[:5]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert [list(r) for r in ours[5]] == [list(r) for r in jhost.read_ids]
    assert tasm.pruned_table_dict(reads) == jasm.pruned_table_dict(reads)
    got, tstats = tasm.assemble(dirty, engine="native")
    want, jstats = jasm.assemble(dirty, engine="native")
    assert got == want and _counters(tstats) == _counters(jstats)
    assert any(not frozenset("ACGT").issuperset(line) for line in got)
    assert [(s, k, list(i)) for s, k, i in tasm.pruned_table_groups(dirty)] == [
        (s, k, list(i)) for s, k, i in jasm.pruned_table_groups(dirty)]
    assert tasm.pruned_table_dict(dirty) == jasm.pruned_table_dict(dirty)


def test_outofcore_nonacgt_equals_in_core():
    reads = _dirty_reads()
    _, ooc = _pair(outofcore_bytes=20_000)
    _, incore = _pair()
    assert ooc._needs_outofcore(reads) and not incore._needs_outofcore(reads)
    for verbose in (False, True):
        assert ooc.assemble(reads, engine="python", verbose=verbose)[0] == \
            incore.assemble(reads, engine="python", verbose=verbose)[0]
    groups, stats, _ = ooc._nonacgt_groups(reads)
    assert groups == incore._nonacgt_groups(reads)[0]
    assert set(stats.wall_s) == {"batch", "count", "extract"}


# -- what is not ported raises ---------------------------------------------

def test_mesh_raises_not_implemented():
    """The mesh count runs (a CPU mesh of 4 shards gives the in-core lines);
    its count-shard checkpoints wait for the next multi-device slice."""
    from genome_assembly_tpu_torch.io import reads as treads
    from genome_assembly_tpu_torch.parallel import mesh as tmesh
    from genome_assembly_tpu_torch.parallel import shard_count

    _, incore = _pair()
    reads = incore.load(str(FIXTURE)) * 4
    assert not incore._needs_outofcore(reads)
    mesh = tmesh.make_mesh(4, devices=["cpu"])
    assert incore.assemble(reads, mesh=mesh)[0] == incore.assemble(reads)[0]
    batches = treads.batch_reads(reads, 32, 64, parity_chars=True)
    with pytest.raises(NotImplementedError, match="multi-device"):
        shard_count.sharded_count_batches(batches, k=6, m=3, parity=True, cutoff=-1,
                                          mesh=mesh, checkpoint_dir="count_shards")
    with pytest.raises(ValueError):
        incore.assemble(reads, engine="rust")
    with pytest.raises(ValueError):
        TParity(TConfig(k=21, m=7, parity=False), device="cpu")


# -- the command line ------------------------------------------------------

def test_cli_assembles_the_fixture_byte_for_byte(tmp_path, capsys):
    from genome_assembly_tpu_torch import cli

    # the module entry point, in a process of its own
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), CUDA_VISIBLE_DEVICES="")
    base = ["assemble", str(FIXTURE), "--k", "6", "--m", "3"]
    r = subprocess.run([sys.executable, "-m", "genome_assembly_tpu_torch"] + base + ["--cpu"],
                       cwd=str(tmp_path), env=env, capture_output=True, timeout=300)
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == (GOLDEN / "input_k6m3_unitigs.txt").read_bytes()

    def run(*extra):
        capsys.readouterr()
        rc = cli.main(base + list(extra))
        return rc, capsys.readouterr().out

    rc, out = run("--mode", "parity", "--verbose-output", "--cpu")
    assert rc == 0 and out == (GOLDEN / "input_k6m3_verbose.txt").read_text()
    # --read-length reaches the fgets emulation: a 10-byte buffer splits
    # every 15-bp line into two reads
    rc, out = run("--cpu", "--read-length", "10", "--cutoff", "0")
    jasm = JParity(JConfig(k=6, m=3, read_length=10, abundance_cutoff=0, max_read_len=32,
                           batch_reads=64))
    want, _ = jasm.assemble(jasm.load(str(FIXTURE)), engine="native")
    assert rc == 0 and out.splitlines() == want
    # without --cpu on a machine without a card: refuses, prints nothing
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        run()
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_cli_outofcore_matches_the_jax_cli(tmp_path, capsys, mode):
    """A small --outofcore-gb sends both CLIs out of core: the same bytes."""
    from genome_assembly_tpu import cli as jcli
    from genome_assembly_tpu_torch import cli

    if mode == "parity":
        path = FIXTURE
        args = ["--k", "6", "--m", "3", "--batch-reads", "64", "--outofcore-gb", "0.00002"]
    else:
        _, reads, _ = jdatagen.generate_coverage_reads(
            genome_len=900, read_len=48, coverage=8, seed=29, with_reverse=True)
        path = tmp_path / "r.txt"
        tdatagen.write_reads(reads, str(path))
        args = ["--mode", "fast", "--k", "11", "--m", "5", "--max-read-len", "64",
                "--batch-reads", "128", "--outofcore-gb", "0.00001"]
    outs = []
    for main in (jcli.main, cli.main):
        capsys.readouterr()
        assert main(["assemble", str(path), "--cpu"] + args) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[1]
    if mode == "parity":
        assert outs[1] == (GOLDEN / "input_k6m3_unitigs.txt").read_text()
    capsys.readouterr()
    assert cli.main(["assemble", str(path), "--cpu"] + args[:-2]) == 0
    incore = capsys.readouterr().out
    # in core: the same unitigs (the same lines, in parity mode)
    assert sorted(incore.split()) == sorted(outs[1].split())

"""The port's genome-scale runner (``genome_assembly_tpu_torch/tools/run_scale.py``)
on the CPU at the ``small`` preset (200 kb x 10x, 2 batches of 16384 reads).

Its read starts are a counter hash, not the JAX tool's ``jax.random``
draws, so the runner as a whole is held by the invariants that
tests/test_scale_runner.py pins for the JAX tool (no cycles, one string a
linear unitig, total_bp = kept + unitigs x (k - 1), longest_bp =
longest_chain + (k - 1), distinct <= G - k + 1) and by its own
configurations agreeing (in core, out of core, super-k-mer, parked, worker
ranges merged); and the JAX package's library functions run on the port's
own batches give the port's kept keys.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genome_assembly_tpu.ops import minimizer as jmin
from genome_assembly_tpu.ops import outofcore as jooc
from genome_assembly_tpu.ops import superkmer as jsk
from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.ops import minimizer, outofcore, superkmer
from genome_assembly_tpu_torch.tools import run_scale

K = 31


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch thread for this module's small tensors: under parallel test
    workers that share the cores, each op's thread team otherwise waits on
    threads the other workers hold (the results do not depend on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run(*extra):
    """The runner's events by name (the last of each), in process."""
    events = {}
    rc = run_scale.main(["--preset", "small", "--cpu", *extra],
                        emit_event=lambda e: events.__setitem__(e["event"], e))
    assert rc == 0
    return events


def _count(ev):
    return ev.get("count") or ev["scan_and_count"]


def _invariants(ev):
    genome_len = ev["config"]["genome_len"]
    kept, m, ext = _count(ev)["kept"], ev["materialize"], ev["extension"]
    assert ext["cyclic_states"] == 0
    assert m["unitigs"] == ext["linear_unitigs"] > 0
    assert m["total_bp"] == kept + m["unitigs"] * (K - 1)
    assert m["longest_bp"] == ext["longest_chain"] + (K - 1)
    assert kept <= _count(ev)["distinct"] <= genome_len - K + 1
    assert _count(ev)["distinct"] > 0.99 * (genome_len - K + 1)


@pytest.fixture(scope="module")
def in_core():
    return _run("--materialize")


def test_in_core_run_meets_the_invariants(in_core):
    _invariants(in_core)
    assert in_core["genome"]["virtual"] is False and in_core["config"]["n_batches"] == 2
    assert in_core["config"]["dataset"] == "gen-ctr-seed0"
    assert in_core["count"]["peak_device_bytes"] is None  # on the CPU


@pytest.mark.parametrize("extra", [
    ("--partitions", "4"),
    ("--partitions", "4", "--super", "--link-partitions", "3", "--link-chunk", "65536"),
    ("--partitions", "4", "--super", "--park-keys", "--park-links",
     "--link-partitions", "3", "--link-chunk", "65536"),
], ids=["outofcore", "super_links_outofcore", "super_parked"])
def test_configurations_agree_with_in_core(in_core, extra):
    """Out of core, super-k-mer staging, out-of-core and parked links: the
    same counts, graph and strings as the in-core run."""
    ev = _run("--materialize", *extra)
    _invariants(ev)
    for name, fields in (("extension", ("linear_unitigs", "cyclic_states", "longest_chain")),
                         ("materialize", ("unitigs", "total_bp", "longest_bp"))):
        assert {f: ev[name][f] for f in fields} == {f: in_core[name][f] for f in fields}
    assert (_count(ev)["distinct"], _count(ev)["kept"]) == \
        (in_core["count"]["distinct"], in_core["count"]["kept"])
    assert ("outofcore_super" in ev) == ("--super" in extra)
    if "--park-links" in extra:
        assert {"links_parked", "link_pass", "link_partition", "links_upload"} <= set(ev)
    elif "--link-partitions" in extra:
        assert "links_outofcore" in ev


def test_partitioned_extension_equals_bulk(in_core):
    """--ext-mode part (part_dbg's routed join and jump on a one-shard
    mesh): bulk's graph stats and strings, both overflows 0."""
    ev = _run("--materialize", "--ext-mode", "part")
    _invariants(ev)
    assert ev["links"]["mode"] == ev["jump"]["mode"] == "part"
    assert ev["links"]["overflow"] == ev["jump"]["overflow"] == 0
    for name, fields in (("extension", ("linear_unitigs", "cyclic_states", "longest_chain")),
                         ("materialize", ("unitigs", "total_bp", "longest_bp"))):
        assert {f: ev[name][f] for f in fields} == {f: in_core[name][f] for f in fields}


def test_ext_mode_wide_is_another_name_of_part(monkeypatch):
    """--ext-mode wide runs part's engine: the port's int64 ids are the JAX
    package's wide form, so there is no second engine to select."""
    class Dispatched(Exception):
        pass

    def partitioned(*args, **kwargs):
        raise Dispatched

    monkeypatch.setattr(run_scale, "_partitioned_extension", partitioned)
    with pytest.raises(Dispatched):
        run_scale.main(["--preset", "small", "--cpu", "--ext-mode", "wide"],
                       emit_event=lambda e: None)


def test_parked_links_emit_the_model_budget_of_the_link_passes():
    """--park-keys --park-links: a ``links_budget`` event before the build,
    whose plan (passes, chunks a sweep, partitions) is what the link build's
    ``link_pass`` / ``link_partition`` events then report."""
    events = []
    assert run_scale.main(["--preset", "small", "--cpu", "--park-keys", "--park-links",
                           "--link-partitions", "3", "--link-chunk", "65536"],
                          emit_event=events.append) == 0
    kinds = [e["event"] for e in events]
    assert kinds.index("links_parked") < kinds.index("links_budget") < kinds.index("link_pass")
    budget = events[kinds.index("links_budget")]
    passes = [e for e in events if e["event"] == "link_pass"]
    parts = [e for e in events if e["event"] == "link_partition"]
    assert budget["partitions"] == len(parts) == 3
    assert budget["n_passes"] == len(passes) >= 1
    assert all(p["chunks"] == budget["n_chunks"] and p["cap_bp"] == budget["cap_bp"]
               for p in passes)
    assert budget["chunk_nodes"] == 65536 and budget["t_total_s"] > 0


def test_virtual_genome_run_meets_the_invariants():
    ev = _run("--materialize", "--virtual-genome")
    _invariants(ev)
    assert ev["genome"]["virtual"] is True and ev["config"]["dataset"] == "vg-ctr-seed0"


def test_worker_ranges_merge_without_a_rescan(monkeypatch, tmp_path, in_core):
    """Two --part-range workers into one directory, then a rangeless run:
    it makes no re-scan (one scan: the probe) and counts what the fresh
    runs count; a count-only run stops at ``total``."""
    scans = []
    real = minimizer.fast_scan
    monkeypatch.setattr(minimizer, "fast_scan",
                        lambda *a, **kw: (scans.append(1), real(*a, **kw))[1])
    base = ("--partitions", "4", "--count-only", "--checkpoint-dir", str(tmp_path))
    done = [_run(*base, "--part-range", r)["count_worker_done"] for r in ("0:2", "2:4")]
    assert [d["part_range"] for d in done] == [[0, 2], [2, 4]]
    scans.clear()
    merged = _run(*base)
    assert len(scans) == 1 and merged["scan_and_count"]["passes"] == 0
    assert merged["scan_and_count"]["kept"] == sum(d["n_kept"] for d in done) == \
        in_core["count"]["kept"]
    assert merged["scan_and_count"]["distinct"] == in_core["count"]["distinct"]
    assert "total" in merged and "extension" not in merged


def test_jax_functions_on_the_port_batches_give_the_port_keys(monkeypatch):
    """The port's own read batches (the first 2048 reads of each) through
    the JAX package's scan, out-of-core count and super-k-mer count, and
    through the port's: the kept keys are equal, in order."""
    ds = run_scale.Dataset("small", k=K, m=7, seed=0, virtual=True, device="cpu")
    torch_codes = [tuple(x[:2048] for x in ds.codes(b)) for b in range(ds.n_batches)]
    codes = [tuple(x.numpy() for x in c) for c in torch_codes]

    def jax_keys(b):
        recs = jmin.fast_scan(jnp.asarray(codes[b][0]), jnp.asarray(codes[b][1]), k=K, m=7)
        sent = jnp.uint32(0xFFFFFFFF)
        return (jnp.where(recs.valid, recs.kmer_hi, sent).reshape(-1),
                jnp.where(recs.valid, recs.kmer_lo, sent).reshape(-1))
    want = jooc.partitioned_count(jax_keys, ds.n_batches, partitions=3, cutoff=1,
                                  kept_cap=1 << 18)
    got = outofcore.partitioned_count(
        lambda b: minimizer.fast_scan(*torch_codes[b], k=K, m=7).kmer.reshape(-1),
        ds.n_batches, partitions=3, cutoff=1)
    assert np.array_equal(got.kmer.numpy(), convert.lanes_to_key(want.kmer_hi, want.kmer_lo))
    kw = dict(k=K, m=7, partitions=2, cutoff=1)
    monkeypatch.setattr(outofcore, "EXPAND_CHUNK", 1 << 12)
    want_s = jooc.partitioned_count_super(
        lambda b: jsk.super_records(jnp.asarray(codes[b][0]), jnp.asarray(codes[b][1]),
                                    k=K, m=7), ds.n_batches, kept_cap=1 << 18,
        expand_chunk=1 << 12, **kw)
    got_s = outofcore.partitioned_count_super(
        lambda b: superkmer.super_records(*torch_codes[b], k=K, m=7), ds.n_batches, **kw)
    assert np.array_equal(got_s.kmer.numpy(),
                          convert.lanes_to_key(want_s.kmer_hi, want_s.kmer_lo))
    assert torch.equal(torch.sort(got_s.kmer).values, torch.sort(got.kmer).values)
    assert got.n_kept > 10_000


def test_batches_are_a_pure_function_of_the_index():
    ds = run_scale.Dataset("small", k=K, m=7, seed=0, virtual=False, device="cpu")
    a, la = ds.codes(1)
    b, _ = ds.codes(1)
    assert torch.equal(a, b) and a.shape == (16384, 128) and (la == 100).all()
    assert (a[:, 100:] == 0).all() and not torch.equal(a, ds.codes(0)[0])
    other = run_scale.Dataset("small", k=K, m=7, seed=0, virtual=False, device="cpu")
    assert torch.equal(other.codes(1)[0], a)


def test_the_runner_needs_the_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        run_scale.main(["--preset", "small"], emit_event=lambda e: None)

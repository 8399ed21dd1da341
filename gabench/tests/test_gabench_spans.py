"""The metrics read from the program's own steps and counters
(``gabench/spans.py``): their entries in ``BENCHMARK.json``, their readers
on a synthetic trace and on one without the program's ranges, and a traced
run of the tiny cells in which each reads above 0."""

import json

import pytest
import torch

from conftest import REPO
from gabench import run, spans, trace
from gabench.run import Assembly, Observed, metric_reader

CPU = torch.device("cpu")
SEED = 2**31 + 4243
# (name, unit, source, layer, cells), appended in this order
NEW = [
    ("batch_encode_s", "s", "program_span", "host ingest", ["ecoli", "yeast"]),
    ("feeder_wait_s", "s", "program_span", "host ingest", ["ecoli"]),
    ("materialize_sort_s", "s", "program_span", "materialize", ["ecoli", "yeast"]),
    ("materialize_revcomp_s", "s", "program_span", "materialize", ["ecoli"]),
    ("h2d_gib", "GiB", "program_counter", "host-device copies", ["ecoli", "yeast"]),
    ("d2h_gib", "GiB", "program_counter", "host-device copies", ["ecoli", "yeast"]),
]
CELLS = {"ecoli": "ecoli_mg1655.hiseq50", "yeast": "yeast_s288c.hiseq50"}
# the tiny cell that takes each real cell's path: in core, and out of core
TINY = {"ecoli_mg1655.hiseq50": "tiny.cov20", "yeast_s288c.hiseq50": "tinyooc.cov20"}
TINY_OF = {"ecoli": "tiny.cov20", "yeast": "tinyooc.cov20"}


def test_the_entries_are_appended_after_the_accepted_ones():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    per_layer = spec["per_layer"]
    assert [m["name"] for m in per_layer[:8]] == [
        "load_s", "batch_s", "scan_s", "scan_roofline_pct", "count_s", "extension_s",
        "materialize_s", "device_idle_pct"]
    got = [(m["name"], m["unit"], m["source"], m["layer"], m["workloads"])
           for m in per_layer[8:8 + len(NEW)]]
    assert got == [(n, u, s, layer, [CELLS[c] for c in cells])
                   for n, u, s, layer, cells in NEW]
    assert all(set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
               and m["moves"] == "assemble_s" and m["better"] == "lower"
               for m in per_layer[8:8 + len(NEW)])
    layers = {m["layer"] for m in per_layer[:8]}
    assert {"host ingest", "materialize"} <= layers
    for name, *_ in NEW:
        assert (REPO / f"gabench/metrics/{name}.py").is_file()


def event(name, ts, dur):
    return {"ph": "X", "name": name, "cat": "user_annotation", "ts": ts, "dur": dur,
            "pid": 0, "tid": 0}


def observed_of(tmp_path, names, assemblies=2):
    """Observed of a synthetic window of 1000 us holding ranges
    (name, start, length) and ``assemblies`` assemblies."""
    events = [event(trace.WINDOW, 1000, 1000)] + [event(n, ts, d) for n, ts, d in names]
    (tmp_path / "trace_1_2.json").write_text(json.dumps({"traceEvents": events}))
    device, ranges, _ = trace.read_trace(tmp_path)
    return Observed(config={}, setup_s=1.0, window_s=1e-3,
                    assemblies=[Assembly(0.0, 1.0, {})] * assemblies,
                    peak_device_bytes=0, trace=trace.Trace(device, ranges))


def test_readers_sum_the_window_s_spans_and_counts_per_assembly(tmp_path):
    obs = observed_of(tmp_path, [
        ("batch", 1000, 400), ("batch.encode", 1010, 100), ("batch.encode", 1200, 60),
        ("scan", 1400, 100), ("scan.wait", 1410, 20),
        ("scan.h2d_bytes=3221225472", 1499, 0), ("materialize", 1500, 400),
        ("materialize.sort", 1600, 200), ("materialize.d2h_bytes=1073741824", 1899, 0),
        ("count.h2d_bytes=1073741824", 1950, 0),
        # outside the window: not read
        ("batch.encode", 2500, 300), ("scan.h2d_bytes=99", 2600, 0)])
    read = {name: metric_reader(REPO, name)(obs) for name, *_ in NEW}
    assert read == {"batch_encode_s": pytest.approx(80e-6),
                    "feeder_wait_s": pytest.approx(10e-6),
                    "materialize_sort_s": pytest.approx(100e-6), "materialize_revcomp_s": None,
                    "h2d_gib": 2.0, "d2h_gib": 0.5}


def test_a_program_without_the_spans_reads_nothing(tmp_path):
    """The ranges a program without steps or counters leaves (its phases
    and the harness's ``load``), and an untraced run: every reader gives
    None, so the line leaves the metric out."""
    obs = observed_of(tmp_path, [("load", 1000, 100), ("batch", 1100, 300),
                                 ("scan", 1400, 100), ("materialize", 1500, 400)])
    untraced = Observed(config={}, setup_s=1.0, window_s=1.0,
                        assemblies=[Assembly(0.0, 1.0, {})], peak_device_bytes=0)
    for name, *_ in NEW:
        assert metric_reader(REPO, name)(obs) is None
        assert metric_reader(REPO, name)(untraced) is None
    assert spans.mean_count(obs, "h2d_bytes") is None


def extend_to_the_tiny_cells(root):
    """List each tiny cell under the new metrics its real cell has, as a
    later change adding such a cell would."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        if "workloads" in m and m["name"] in {n for n, *_ in NEW}:
            m["workloads"] += [TINY[c] for c in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.mark.parametrize("cell", ["tiny.cov20", "tinyooc.cov20"])
def test_each_new_metric_reads_above_0_where_its_cell_is_listed(bench_copy, cell):
    extend_to_the_tiny_cells(bench_copy)
    spec = json.loads((bench_copy / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in spec["per_layer"] if cell in m.get("workloads", [])}
    assert listed == {n for n, *_, cells in NEW if cell in {TINY_OF[c] for c in cells}}
    traced = run.run_cell(bench_copy, cell, SEED, 0.3, True, CPU)
    assert traced["correct"] is True
    assert listed <= set(traced["metrics"])
    assert all(traced["metrics"][n]["value"] > 0 for n in listed)
    untraced = run.run_cell(bench_copy, cell, SEED, 0.3, False, CPU)
    assert not listed & set(untraced["metrics"])

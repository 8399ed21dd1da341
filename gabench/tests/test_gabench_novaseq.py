"""The cell of 150-bp reads, ``ecoli_mg1655_150.novaseq100``: its geometry
(reads, batches, slots, the out-of-core plan), its entries in
``BENCHMARK.json``, and the two metrics it brings, ``window_fill_pct``
and ``count_staged_gib``: their readers on synthetic traces, on a trace
without the program's counters, and in a traced run of the tiny cells."""

import json

import numpy as np
import pytest
import torch

from conftest import REPO, TINY_CELLS
from gabench import generate, run, spans, trace
from gabench.run import Assembly, Observed, metric_reader
from genome_assembly_tpu_torch.ops import outofcore

CPU = torch.device("cpu")
SEED = 2**31 + 4244
CELL = "ecoli_mg1655_150.novaseq100"
OLD_CELLS = ["ecoli_mg1655.hiseq50", "yeast_s288c.hiseq50"]
NEW_METRICS = ["window_fill_pct", "count_staged_gib"]


def geometry(config: dict, traffic: dict) -> dict:
    """What the fast path makes of a cell: its reads, batches, window slots
    and windows, and, out of core, the partitions (the pipeline's
    ``_unitigs_outofcore``), the staging plan (``outofcore.range_group_plan``
    at the default budget), its passes and staged bytes."""
    p = config["pipeline"]
    n_reads = generate.read_count(config["genome"]["length"], traffic["coverage"],
                                  traffic["read_len"])
    n_batches = -(-n_reads // p["batch_reads"])
    n_win = p["max_read_len"] - p["k"] + 1
    slots = n_batches * p["batch_reads"] * n_win
    out = {"reads": n_reads, "batches": n_batches, "slots": slots,
           "windows": n_reads * (traffic["read_len"] - p["k"] + 1),
           "out_of_core": slots * 8 > p["outofcore_bytes"]}
    if out["out_of_core"]:
        partitions = max(1, int(np.ceil(slots * 8 / (p["outofcore_bytes"] / 3))))
        cap, group = outofcore.range_group_plan(
            n_batches, p["batch_reads"] * n_win, partitions=partitions, bytes_per_record=8,
            budget_bytes=outofcore.GROUP_BUDGET_BYTES)
        passes = -(-partitions // group)
        out.update(partitions=partitions, group=group, passes=passes,
                   staged_bytes=passes * group * n_batches * cap * 8)
    return out


def fill_pct(g: dict, first_batch_windows: int) -> float:
    """window_fill_pct of one assembly: in core one scan of every batch; out
    of core the probe of batch 0, then every batch each pass."""
    if not g["out_of_core"]:
        return 100.0 * g["windows"] / g["slots"]
    probe_slots = g["slots"] // g["batches"]
    return 100.0 * (first_batch_windows + g["passes"] * g["windows"]) / (
        probe_slots + g["passes"] * g["slots"])


def cell_geometry(name: str):
    _, config, traffic, _ = run.cell_spec(REPO, name)
    return config, traffic, geometry(config, traffic)


def test_the_cell_counts_out_of_core_in_six_partitions_in_one_pass():
    config, traffic, g = cell_geometry(CELL)
    assert config["pipeline"]["max_read_len"] == 256 and traffic["read_len"] == 150
    assert (g["reads"], g["batches"], g["slots"]) == (3_094_434, 189, 699_826_176)
    assert g["out_of_core"] and g["slots"] * 8 == 5_598_609_408  # 5.60 GB of keys
    assert (g["partitions"], g["group"], g["passes"]) == (6, 6, 1)
    assert g["staged_bytes"] / 2**30 == pytest.approx(5.268, abs=5e-4)
    assert g["windows"] == 371_332_080
    first = config["pipeline"]["batch_reads"] * 120
    assert fill_pct(g, first) == pytest.approx(53.06, abs=0.01)
    # the accepted cells, for the metric's expected readings there
    ecoli = cell_geometry(OLD_CELLS[0])[2]
    yeast = cell_geometry(OLD_CELLS[1])[2]
    assert not ecoli["out_of_core"] and yeast["partitions"] == 5 and yeast["passes"] == 1
    assert fill_pct(ecoli, 0) == pytest.approx(71.25, abs=0.01)
    assert fill_pct(yeast, 16384 * 70) == pytest.approx(71.24, abs=0.01)
    assert yeast["staged_bytes"] / 2**30 == pytest.approx(4.514, abs=5e-4)


def test_the_configuration_and_traffic_files():
    config = json.loads((REPO / "gabench/configs/ecoli_mg1655_150.json").read_text())
    ecoli = json.loads((REPO / "gabench/configs/ecoli_mg1655.json").read_text())
    assert config["name"] == "ecoli_mg1655_150"
    assert config["genome"] == ecoli["genome"]
    assert config["guarantees"] == ecoli["guarantees"] and config["assumed"] == ecoli["assumed"]
    assert config["pipeline"] == dict(ecoli["pipeline"], max_read_len=256)
    assert "NC_000913.3" in config["source"] and "--max-read-len" in config["source"]
    traffic = json.loads((REPO / "gabench/traffic/novaseq100.json").read_text())
    hiseq = json.loads((REPO / "gabench/traffic/hiseq50.json").read_text())
    assert traffic == dict(hiseq, name="novaseq100", source=traffic["source"], read_len=150,
                           coverage=100)
    made = generate.for_cell(SEED, dict(config, genome={"length": 3000}), traffic)
    assert made.reads.shape == (2000, 150)


def test_the_three_entries_are_appended():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    assert [c["name"] for c in spec["configs"]] == ["ecoli_mg1655", "yeast_s288c",
                                                   "ecoli_mg1655_150"]
    config = spec["configs"][-1]
    assert config["file"] == "gabench/configs/ecoli_mg1655_150.json" and config["reduced"] == []
    assert config["source"] == json.loads((REPO / config["file"]).read_text())["source"]
    assert len(config["source"]) <= 200 and len(config["why"]) <= 200
    assert [w["name"] for w in spec["workloads"]] == [*OLD_CELLS, CELL]
    cell = spec["workloads"][-1]
    assert {k: cell[k] for k in ("config", "traffic", "chips")} == {
        "config": "ecoli_mg1655_150", "traffic": "novaseq100", "chips": 1}
    assert len(cell["why"]) <= 200
    assert len(spec["per_layer"]) == 16
    assert [m["name"] for m in spec["per_layer"][14:]] == NEW_METRICS
    fill, staged = spec["per_layer"][14:]
    # the fill lists no cells: it is read in every cell, those added later
    # too; the staging only in the cells that count out of core (an in-core
    # count stages nothing, and the reader reads nothing there)
    assert fill == {"name": "window_fill_pct", "unit": "%", "better": "higher",
                    "source": "program_counter", "layer": "scan", "moves": "assemble_s"}
    assert staged == {"name": "count_staged_gib", "unit": "GiB", "better": "lower",
                      "source": "program_counter", "layer": "count",
                      "moves": "peak_device_gib", "workloads": [OLD_CELLS[1], CELL]}
    for cell in [*OLD_CELLS, CELL]:
        traced = {m["name"] for m in run.cell_metrics(spec, cell, True)}
        assert ("window_fill_pct" in traced) and ("count_staged_gib" in traced) == (
            cell != OLD_CELLS[0])
    # the layers are named as the accepted metrics name them
    layers = {m["layer"] for m in spec["per_layer"][:15]}
    assert {"scan", "count"} <= layers
    for name in NEW_METRICS:
        assert (REPO / f"gabench/metrics/{name}.py").is_file()
    # the new cell reports every accepted metric that lists no cells
    traced = {m["name"] for m in run.cell_metrics(spec, CELL, True)}
    assert {m["name"] for m in spec["per_layer"] if "workloads" not in m} <= traced


def observed_of(tmp_path, names, assemblies=2):
    """Observed of a synthetic window of 1000 us holding zero-length ranges
    ``names`` and ``assemblies`` assemblies."""
    def event(name, ts, dur):
        return {"ph": "X", "name": name, "cat": "user_annotation", "ts": ts, "dur": dur,
                "pid": 0, "tid": 0}
    events = [event(trace.WINDOW, 1000, 1000)] + [
        event(n, 1000 + 10 * i, 0) for i, n in enumerate(names)] + [
        event("scan.slots=999", 2500, 0)]  # outside the window: not read
    (tmp_path / "trace_1_2.json").write_text(json.dumps({"traceEvents": events}))
    device, ranges, _ = trace.read_trace(tmp_path)
    return Observed(config={}, setup_s=1.0, window_s=1e-3,
                    assemblies=[Assembly(0.0, 1.0, {})] * assemblies,
                    peak_device_bytes=0, trace=trace.Trace(device, ranges))


def read_all(observed):
    return {name: metric_reader(REPO, name)(observed) for name in NEW_METRICS}


def test_readers_on_a_synthetic_trace(tmp_path):
    # two assemblies: in the count phase 400 + 400 slots, 100 + 200 windows
    obs = observed_of(tmp_path, [
        "count.slots=400", "count.windows=100", "count.staged_bytes=1073741824",
        "count.partitions=6", "count.passes=1",
        "count.slots=400", "count.windows=200", "count.staged_bytes=3221225472"])
    assert read_all(obs) == {"window_fill_pct": pytest.approx(37.5),
                             "count_staged_gib": pytest.approx(2.0)}
    # in core: the scan phase's counters, and no staging
    obs = observed_of(tmp_path, ["scan.slots=128", "scan.windows=96"], assemblies=1)
    assert read_all(obs) == {"window_fill_pct": 75.0, "count_staged_gib": None}


def test_readers_without_the_counters_read_nothing(tmp_path):
    """The ranges a program without the counters leaves (its phases, the
    harness's ``load``, the copy counters), and an untraced run."""
    obs = observed_of(tmp_path, ["load", "batch", "count", "count.h2d_bytes=4096",
                                 "materialize.d2h_bytes=64"])
    assert read_all(obs) == {"window_fill_pct": None, "count_staged_gib": None}
    untraced = Observed(config={}, setup_s=1.0, window_s=1.0,
                        assemblies=[Assembly(0.0, 1.0, {})], peak_device_bytes=0)
    assert read_all(untraced) == {"window_fill_pct": None, "count_staged_gib": None}
    assert spans.mean_count(obs, "slots") is None


def list_the_tiny_ooc_cell(root):
    """List the tiny out-of-core cell under the staging, as its real cells
    are listed."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        if m["name"] == "count_staged_gib":
            m["workloads"] += ["tinyooc.cov20"]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.mark.parametrize("cell", ["tiny.cov20", "tinyooc.cov20"])
def test_a_traced_run_of_the_tiny_cells_reads_both(bench_copy, cell):
    list_the_tiny_ooc_cell(bench_copy)
    traced = run.run_cell(bench_copy, cell, SEED, 0.3, True, CPU)
    assert traced["correct"] is True
    metrics = {n: m["value"] for n, m in traced["metrics"].items()}
    _, config, traffic, _ = run.cell_spec(bench_copy, cell)
    g = geometry(config, traffic)
    assert g["out_of_core"] == (cell == "tinyooc.cov20")
    first = config["pipeline"]["batch_reads"] * (traffic["read_len"] - config["pipeline"]["k"] + 1)
    assert metrics["window_fill_pct"] == pytest.approx(fill_pct(g, first), rel=1e-12)
    assert 0 < metrics["window_fill_pct"] < 100
    if g["out_of_core"]:
        assert config["pipeline"]["outofcore_bytes"] == TINY_CELLS["tinyooc"]
        assert metrics["count_staged_gib"] == pytest.approx(g["staged_bytes"] / 2**30,
                                                            rel=1e-12)
        assert metrics["count_staged_gib"] > 0
    else:
        assert "count_staged_gib" not in metrics
    untraced = run.run_cell(bench_copy, cell, SEED, 0.3, False, CPU)
    assert not set(NEW_METRICS) & set(untraced["metrics"])

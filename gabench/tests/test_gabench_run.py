"""The harness: lookup by name, the result line, the faults ``correct``
must catch, the import rules, and (on a card) a whole run."""

import ast
import hashlib
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from conftest import REPO, add_tiny_cells
from gabench import run
from gabench.reference import dbg_unitigs as ref

CPU = torch.device("cpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2**31 + 4242


def test_benchmark_json_keeps_the_contract():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    assert list(spec) == ["command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"]
    assert spec["paths"] == ["gabench"] and spec["command"][1:] == ["-m", "gabench.run"]
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"] == f"gabench/configs/{c['name']}.json" and (REPO / c["file"]).is_file()
        assert c["reduced"] == [] and 1 <= len(c["why"]) <= 200 and len(c["source"]) <= 200
        assert json.loads((REPO / c["file"]).read_text())["source"] == c["source"]
    assert [w["name"] for w in spec["workloads"]] == ["ecoli_mg1655.hiseq50",
                                                      "yeast_s288c.hiseq50",
                                                      "ecoli_mg1655_150.novaseq100"]
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}" and w["config"] in configs
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and NAME.match(w["traffic"])
        assert (REPO / f"gabench/traffic/{w['traffic']}.json").is_file()
    assert {c["config"] for c in spec["workloads"]} == set(configs)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert list(e2e) == ["assemble_s", "peak_device_gib", "setup_s"]
    assert 0.01 <= min(m["bound"] for m in e2e.values()) and e2e["setup_s"]["bound"] <= 0.25
    assert all(m["bound"] <= 0.25 for m in e2e.values())
    layer_names = ["load_s", "batch_s", "scan_s", "scan_roofline_pct", "count_s",
                   "extension_s", "materialize_s", "device_idle_pct", "batch_encode_s",
                   "feeder_wait_s", "materialize_sort_s", "materialize_revcomp_s", "h2d_gib",
                   "d2h_gib", "window_fill_pct", "count_staged_gib"]
    assert [m["name"] for m in spec["per_layer"]] == layer_names
    for kind, metrics in (("end_to_end", spec["end_to_end"]), ("per_layer", spec["per_layer"])):
        for m in metrics:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in (
                "lower", "higher")
            assert (REPO / f"gabench/metrics/{m['name']}.py").is_file()
            if kind == "per_layer":
                assert m["moves"] == ("peak_device_gib" if m["name"] == "count_staged_gib"
                                      else "assemble_s") and 1 <= len(m["layer"]) <= 200
                assert set(m.get("workloads", [])) <= {w["name"] for w in spec["workloads"]}
                assert m["source"] in ("device_trace", "program_span", "program_counter",
                                       "host_clock")
            else:
                assert m["source"] == "host_clock"
    for w in spec["workloads"]:
        assert [m["name"] for m in run.cell_metrics(spec, w["name"], False)] == list(e2e)
        assert run.cell_metrics(spec, w["name"], True)
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_cells_and_metrics_are_found_by_name():
    cell, config, traffic, _ = run.cell_spec(REPO, "yeast_s288c.hiseq50")
    assert config["name"] == "yeast_s288c" and traffic["name"] == "hiseq50"
    assert cell["chips"] == 1
    with pytest.raises(ValueError, match="unknown workload"):
        run.cell_spec(REPO, "yeast_s288c.nanopore")
    with pytest.raises(ValueError, match="no reader"):
        run.metric_reader(REPO, "tokens_per_s")


def digest(root: pathlib.Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_configuration_runs_by_adding_files_only(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root)
    shutil.copytree(REPO / "gabench", root / "gabench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = digest(root / "gabench")
    add_tiny_cells(root)
    after = digest(root / "gabench")
    assert {p: h for p, h in after.items() if p in before} == before
    result = run.run_cell(root, "tiny.cov20", SEED, 0.5, False, CPU)
    assert result["correct"] and set(result["metrics"]) == {"assemble_s", "peak_device_gib",
                                                            "setup_s"}


@pytest.mark.parametrize("cell", ["tiny.cov20", "tinyooc.cov20"])
@pytest.mark.parametrize("traced", [False, True])
def test_result_line(bench_copy, cell, traced):
    result = run.run_cell(bench_copy, cell, SEED, 0.3, traced, CPU)
    assert list(result) == (["correct", "attempted", "failed", "metrics", "device"]
                            + (["breakdown"] if traced else []) + ["window", "checks"])
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert result["checks"] == {n: {"value": 0, "limit": limit} for n, limit in ref.LIMITS.items()}
    spec = json.loads((bench_copy / "BENCHMARK.json").read_text())
    want = {m["name"]: m["unit"] for m in run.cell_metrics(spec, cell, traced)}
    # a CPU trace has no device activity: those metrics read nothing
    cpu_silent = {"scan_roofline_pct", "device_idle_pct"} if traced else set()
    assert {n: m["unit"] for n, m in result["metrics"].items()} == {
        n: u for n, u in want.items() if n not in cpu_silent}
    # scan_s is listed for the E. coli cell alone; out of core the scan is inside count
    assert "scan_s" not in result["metrics"]
    assert all(("scan" in p) == (cell == "tiny.cov20") for p in result["window"]["phase_s"])
    assert all(m["value"] > 0 for n, m in result["metrics"].items() if n != "peak_device_gib")
    device = result["device"]
    assert device["platform"] == "cpu" and device["count"] == 1
    assert ("busy_s" in device) == traced
    if traced:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(result)


def test_main_refuses_without_the_cards_the_cell_needs(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "ecoli_mg1655.hiseq50", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_a_checkout_without_the_port_prints_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "gabench", tmp_path / "gabench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    done = subprocess.run(
        [sys.executable, "-m", "gabench.run", "--workload", "ecoli_mg1655.hiseq50", "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert done.returncode != 0 and done.stdout == ""
    assert "genome_assembly_tpu_torch" in done.stderr


def test_main_refuses_a_process_that_loaded_jax(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: {"checks": {}})
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert run.main(["--workload", "ecoli_mg1655.hiseq50", "--seed", "1", "--seconds", "1"]) != 0
    captured = capsys.readouterr()
    assert captured.out == "" and "jaxlib.xla_client" in captured.err


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "genome_assembly_tpu_torch_x", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert all(m.split(".")[0] in run.FORBIDDEN for m in run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "genome_assembly_tpu.cli", object())
    assert "genome_assembly_tpu.cli" in run.forbidden_modules()


def imported_top_levels(path: pathlib.Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (REPO / "gabench").rglob("*.py"):
        assert not imported_top_levels(path) & set(run.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (REPO / "gabench" / "reference").rglob("*.py"):
        names = imported_top_levels(path)
        assert names <= {"__future__", "collections", "math", "typing", "numpy", "torch"}, path


def break_count(monkeypatch):
    """A step that returns its state unchanged: the prune keeps every k-mer."""
    from genome_assembly_tpu_torch.ops import count

    real = count.count_keys
    monkeypatch.setattr(count, "count_keys", lambda keys, cutoff, **kw: real(keys, cutoff=-1, **kw))
    from genome_assembly_tpu_torch.ops import outofcore

    real_ooc = outofcore.partitioned_count
    monkeypatch.setattr(outofcore, "partitioned_count",
                        lambda *a, cutoff, **kw: real_ooc(*a, cutoff=-1, **kw))


def break_batch(monkeypatch):
    """Half of every batch left out: its second half's reads made empty, in
    the padded batches and in fast mode's flat ones (their bases cut to the
    reads that stay)."""
    from genome_assembly_tpu_torch.io import reads as reads_io

    real, real_flat = reads_io.batch_reads, reads_io.flat_batches

    def half(*a, **kw):
        batches = real(*a, **kw)
        for b in batches:
            b.lengths[b.n // 2:] = 0
        return batches

    def half_flat(*a, **kw):
        batches = real_flat(*a, **kw)
        for b in batches:
            b.lengths[b.n // 2:] = 0
            b.bases = b.bases[:int(b.lengths.sum())]
        return batches
    monkeypatch.setattr(reads_io, "batch_reads", half)
    monkeypatch.setattr(reads_io, "flat_batches", half_flat)


def break_materialize(monkeypatch):
    """An answer altered where it is produced: one base of one unitig."""
    from genome_assembly_tpu_torch.ops import dbg

    def altered(fn):
        def wrapper(*a, **kw):
            out = fn(*a, **kw)
            unitigs = out[0] if isinstance(out, tuple) else out
            s = unitigs[0]
            unitigs[0] = s[:-1] + ("A" if s[-1] != "A" else "C")
            return out
        return wrapper
    monkeypatch.setattr(dbg, "materialize_unitigs", altered(dbg.materialize_unitigs))
    monkeypatch.setattr(dbg, "materialize_unitigs_device",
                        altered(dbg.materialize_unitigs_device))


def break_load(monkeypatch):
    """A read lost at ingest."""
    from genome_assembly_tpu_torch.models.pipeline import FastAssembler

    real = FastAssembler.load
    monkeypatch.setattr(FastAssembler, "load", lambda self, path: real(self, path)[:-1])


@pytest.mark.parametrize("cell", ["tiny.cov20", "tinyooc.cov20"])
@pytest.mark.parametrize("fault", [break_count, break_batch, break_materialize, break_load])
def test_a_broken_timed_path_is_not_correct(bench_copy, monkeypatch, cell, fault):
    """The whole run but the look for a card, with the program broken
    underneath.  One chip and no exchange: no fault between chips exists."""
    fault(monkeypatch)
    result = run.run_cell(bench_copy, cell, SEED, 0.2, False, CPU)
    assert result["correct"] is False and result["failed"] == result["attempted"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_each_assembly_is_judged_on_its_own_load(bench_copy, monkeypatch):
    """A read lost at ingest in the window's first assembly alone is caught,
    though the later assemblies load every read.  The harness's clock jumps
    past the window's end once the load of the window's second assembly
    ends, so the window holds two assemblies however busy the machine."""
    from genome_assembly_tpu_torch.models.pipeline import FastAssembler

    real, calls = FastAssembler.load, []

    def load(self, path):
        calls.append(path)
        reads = real(self, path)
        # the first call is set-up's warm-up, the second the window's first
        return reads[:-1] if len(calls) == 2 else reads

    def perf_counter():
        return time.perf_counter() + (1e6 if len(calls) >= 3 else 0.0)
    monkeypatch.setattr(FastAssembler, "load", load)
    monkeypatch.setattr(run, "time", types.SimpleNamespace(perf_counter=perf_counter,
                                                           time_ns=time.time_ns))
    result = run.run_cell(bench_copy, "tiny.cov20", SEED, 600.0, False, CPU)
    assert result["attempted"] == 2 and result["failed"] == 1 and result["correct"] is False
    assert result["checks"]["reads_diff"]["value"] == 1


@pytest.mark.card
def test_a_whole_run_on_the_card(card, tmp_path):
    """The command as the benchmark runs it, on a tiny cell, from a copy of
    the checkout that holds the port, traced."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root)
    for d in ("gabench", "genome_assembly_tpu_torch"):
        shutil.copytree(REPO / d, root / d, ignore=shutil.ignore_patterns("__pycache__"))
    add_tiny_cells(root)
    for trace in ("0", "1"):
        done = subprocess.run(
            [sys.executable, "-m", "gabench.run", "--workload", "tiny.cov20", "--seed",
             str(SEED), "--seconds", "2", "--trace", trace],
            cwd=root, capture_output=True, text=True, timeout=900)
        assert done.returncode == 0, done.stderr[-4000:]
        result = json.loads(done.stdout.splitlines()[-1])
        assert result["correct"] is True and result["device"]["platform"] == "gpu"
        assert done.stderr.splitlines()[-1].startswith("unitigs_diff 0 limit 0")
        if trace == "1":
            assert 0 < result["device"]["busy_s"] < result["device"]["window_s"]
            assert 0 < result["metrics"]["scan_roofline_pct"]["value"] <= 100

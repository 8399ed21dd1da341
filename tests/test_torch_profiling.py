"""The port's trace capture (utils/profiling.py) and the pipeline's phase
ranges, on the CPU.

``maybe_trace(None)`` does nothing; ``maybe_trace(dir)`` writes one
Chrome-trace JSON file holding one range a phase of a fast ``unitigs`` run
(batch, scan, count, links, jump, materialize) and of a parity run (batch,
scan, count, extract, replay); the ranges change no result and leave
``wall_s`` with the same phases; ``annotate`` works without CUDA; the CLI's
``assemble --trace`` writes the trace with an ``assemble`` range around the
phases; where a card is present but CUDA activity cannot be recorded,
``maybe_trace`` refuses rather than write a host-only trace.
"""

import collections
import json
import pathlib

import pytest
import torch

from genome_assembly_tpu_torch import cli as tcli
from genome_assembly_tpu_torch.config import PipelineConfig
from genome_assembly_tpu_torch.io import datagen
from genome_assembly_tpu_torch.models.pipeline import FastAssembler, ParityAssembler
from genome_assembly_tpu_torch.utils import profiling

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
FAST_PHASES = ["batch", "scan", "count", "links", "jump", "materialize"]
PARITY_PHASES = ["batch", "scan", "count", "extract", "replay"]


def _reads():
    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=1500, read_len=60, coverage=6, seed=3, with_reverse=True)
    return reads


def _ranges(trace_dir):
    """(name, start, end) of every user range of the one trace in the
    directory, in start order."""
    (path,) = pathlib.Path(trace_dir).glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation"]
    return sorted(spans, key=lambda s: s[1])


def test_no_directory_traces_nothing(tmp_path):
    with profiling.maybe_trace(None):
        assert not torch.autograd.profiler._is_profiler_enabled
        x = torch.arange(10).sum()
    assert int(x) == 45 and list(tmp_path.iterdir()) == []


def test_annotate_works_without_cuda():
    assert not torch.cuda.is_available()
    with profiling.annotate("outside a trace"):
        y = torch.ones(3).sum()
    assert float(y) == 3.0
    with pytest.raises(KeyError):
        with profiling.annotate("raising"):
            raise KeyError("x")


@pytest.mark.parametrize("mode", ["fast", "parity"])
def test_trace_holds_one_range_a_phase(tmp_path, mode):
    if mode == "fast":
        asm = FastAssembler(PipelineConfig(k=21, m=7, parity=False, batch_reads=32), device="cpu")
        reads, phases = _reads(), FAST_PHASES
        run = asm.unitigs
    else:
        asm = ParityAssembler(PipelineConfig(k=6, m=3, max_read_len=32, batch_reads=8),
                              device="cpu")
        reads, phases = asm.load(str(GOLDEN / "input.txt")), PARITY_PHASES
        run = asm.assemble
    plain, plain_stats = run(reads)
    with profiling.maybe_trace(str(tmp_path)):
        traced, stats = run(reads)
    assert traced == plain
    assert list(stats.wall_s) == list(plain_stats.wall_s) == phases
    spans = _ranges(tmp_path)
    assert [name for name, _, _ in spans] == phases
    # the phases follow one another without overlap
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


def test_cli_trace_and_metrics(tmp_path, capsys):
    datagen.write_reads(_reads(), str(tmp_path / "r.txt"))
    args = ["assemble", str(tmp_path / "r.txt"), "--mode", "fast", "--k", "21", "--m", "7",
            "--cpu"]
    assert tcli.main(args) == 0
    plain = capsys.readouterr().out
    assert tcli.main(args + ["--trace", str(tmp_path / "tr"),
                             "--metrics", str(tmp_path / "m.jsonl")]) == 0
    assert capsys.readouterr().out == plain
    spans = _ranges(tmp_path / "tr")
    names = collections.Counter(name for name, _, _ in spans)
    assert names == collections.Counter(["assemble", *FAST_PHASES])
    outer = next(s for s in spans if s[0] == "assemble")
    assert all(outer[1] <= s[1] and s[2] <= outer[2] for s in spans)
    assert json.loads((tmp_path / "m.jsonl").read_text())["event"] == "assemble"


def test_a_card_without_cuda_tracing_is_refused(tmp_path, monkeypatch):
    """Where a CUDA device is present but the profiler cannot record its
    activity, no trace is written: it raises."""
    from torch.profiler import ProfilerActivity

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.profiler, "supported_activities", lambda: {ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="CUDA activity"):
        with profiling.maybe_trace(str(tmp_path)):
            pass
    assert list(tmp_path.glob("*.json")) == []


def test_a_run_asked_onto_the_cpu_traces_the_host_only(tmp_path, monkeypatch):
    """``cuda=False`` (the CLI's ``--cpu``) records no card activity even
    where a card is present, and writes the host's trace."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: None)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: None)
    with profiling.maybe_trace(str(tmp_path), cuda=False):
        with profiling.annotate("host"):
            torch.ones(4).sum()
    assert [name for name, _, _ in _ranges(tmp_path)] == ["host"]

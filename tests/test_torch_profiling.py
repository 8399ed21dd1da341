"""The port's trace capture and run recorder (utils/profiling.py) and the
pipeline's phase ranges and step spans, on the CPU.

``maybe_trace(None)`` does nothing; ``maybe_trace(dir)`` writes one
Chrome-trace JSON file whose top-level ranges are the phases of a fast
``unitigs`` run (batch, scan, count, links, jump, materialize) and of a
parity run (batch, scan, count, extract, replay), in order, with every step
span (``<phase>.<step>``) and counter mark (``<phase>.<counter>=<n>``)
inside its phase; the ranges change no result and leave ``wall_s`` with
the same phases; ``spans_s`` holds the steps each fast path opens, in core
and out of core; a run that raises leaves no range open and no recorder
active; ``h2d_bytes`` and ``d2h_bytes`` follow from the batches and the
kept keys; ``annotate`` works without CUDA; the CLI's ``assemble --trace``
writes the trace with an ``assemble`` range around ``load`` and the
phases, and ``--metrics`` carries the run's phases, spans and counts; where
a card is present but CUDA activity cannot be recorded, ``maybe_trace``
refuses rather than write a host-only trace.
"""

import collections
import json
import pathlib

import pytest
import torch

from genome_assembly_tpu_torch import cli as tcli
from genome_assembly_tpu_torch.config import PipelineConfig
from genome_assembly_tpu_torch.io import datagen
from genome_assembly_tpu_torch.io import reads as treads
from genome_assembly_tpu_torch.models.pipeline import FastAssembler, ParityAssembler
from genome_assembly_tpu_torch.ops import dbg, outofcore
from genome_assembly_tpu_torch.utils import profiling

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
FAST_PHASES = ["batch", "scan", "count", "links", "jump", "materialize"]
OOC_PHASES = ["batch", "count", "links", "jump", "materialize"]
PARITY_PHASES = ["batch", "scan", "count", "extract", "replay"]
MATERIALIZE_SPANS = [f"materialize.{s}" for s in
                     ("readback", "revcomp", "cycles", "sort", "spell", "strands")]
# fast mode's batches are flat: the host joins their bases (``encode``) and
# scatters nothing, the stager packs them on the device
INCORE_SPANS = ["batch.encode", "scan.wait", *MATERIALIZE_SPANS]
OOC_SPANS = ["batch.encode", "count.stage", "count.scan", "count.extract",
             "count.partition", *MATERIALIZE_SPANS]
# the fast configurations of these tests: in core, and forced out of core
FAST = dict(k=21, m=7, parity=False, batch_reads=32)
FAST_OOC = dict(FAST, outofcore_bytes=1 << 14)


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


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2] and outer[2] - outer[1] > (
        inner[2] - inner[1])


def _top_level(spans):
    """The ranges inside no longer one, and for each other range the
    top-level range it lies in."""
    top = [s for s in spans if not any(_inside(s, o) for o in spans)]
    parent = {s: next(t for t in top if _inside(s, t)) for s in spans if s not in top}
    return top, parent


def _check_nesting(spans, phases):
    """The top-level ranges are the phases in order, one after another;
    every other range is a step or a counter mark of the phase it lies in."""
    top, parent = _top_level(spans)
    assert [name for name, _, _ in top] == phases
    assert all(a[2] <= b[1] for a, b in zip(top, top[1:]))
    for s, t in parent.items():
        assert s[0].split(".")[0] == t[0] and "." in s[0], (s, t)
    return {s[0] for s in parent}


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
    # the phases follow one another without overlap; steps lie inside them
    inner = _check_nesting(_ranges(tmp_path), phases)
    assert {n for n in inner if "=" not in n} == set(stats.spans_s)
    marks = {n.split("=")[0] for n in inner if "=" in n}
    assert marks == ({"scan.h2d_bytes", "scan.packed_batches", "scan.slots", "scan.windows",
                      "materialize.h2d_bytes", "materialize.d2h_bytes", "materialize.on_device"}
                     if mode == "fast"
                     else {"scan.h2d_bytes"})


@pytest.mark.parametrize("config,phases,steps", [(FAST, FAST_PHASES, INCORE_SPANS),
                                                  (FAST_OOC, OOC_PHASES, OOC_SPANS)],
                         ids=["incore", "outofcore"])
def test_each_fast_path_opens_its_steps(tmp_path, config, phases, steps):
    """A traced fast run in core and out of core: the same unitigs as
    untraced, ``wall_s`` with the same phases, every step of the path in
    ``spans_s`` and as a range inside its phase, and ``load`` a range of
    its own (no run is in progress while it reads)."""
    path = tmp_path / "r.txt"
    datagen.write_reads(_reads(), str(path))
    asm = FastAssembler(PipelineConfig(**config), device="cpu")
    plain, plain_stats = asm.unitigs(asm.load(str(path)))
    with profiling.maybe_trace(str(tmp_path / "tr")):
        reads = asm.load(str(path))
        traced, stats = asm.unitigs(reads)
    assert traced == plain and sorted(plain_stats.spans_s) == sorted(steps)
    assert list(stats.wall_s) == list(plain_stats.wall_s) == phases
    assert sorted(stats.spans_s) == sorted(steps)
    assert all(v > 0 for v in stats.spans_s.values())
    spans = _ranges(tmp_path / "tr")
    assert spans[0][0] == "load" and not any(_inside(s, spans[0]) for s in spans)
    inner = _check_nesting(spans[1:], phases)
    assert {n for n in inner if "=" not in n} == set(steps)
    # a step's seconds are its ranges' lengths
    for name in ("batch.encode", "materialize.sort"):
        lengths = sum(b - a for n, a, b in spans if n == name) / 1e6
        assert lengths == pytest.approx(stats.spans_s[name], rel=0.5, abs=2e-3)


def test_an_overflowed_partition_is_a_reextract_step(monkeypatch):
    """A partition whose staging cap overflowed is re-extracted alone: its
    own step, ``count.reextract``, beside the others."""
    reads = _reads()
    want, _ = FastAssembler(PipelineConfig(**FAST_OOC), device="cpu").unitigs(reads)
    real = outofcore.range_group_plan

    def tiny_cap(*a, **kw):
        cap, group = real(*a, **kw)
        return min(cap, 64), group
    monkeypatch.setattr(outofcore, "range_group_plan", tiny_cap)
    got, stats = FastAssembler(PipelineConfig(**FAST_OOC), device="cpu").unitigs(reads)
    assert sorted(got) == sorted(want)
    assert sorted(stats.spans_s) == sorted([*OOC_SPANS, "count.reextract"])


def test_a_run_that_raises_leaves_nothing_open(tmp_path, monkeypatch):
    """An exception in the last phase: the phase's range is closed (it is in
    the trace), the clock holds no phase, no recorder stays active, and the
    phases before it were timed."""
    seen = []

    def failing(*a, **kw):
        seen.append(profiling._RECORDER.get())
        raise RuntimeError("materializer failed")
    monkeypatch.setattr(dbg, "materialize_unitigs_device", failing)
    asm = FastAssembler(PipelineConfig(**FAST), device="cpu")
    with profiling.maybe_trace(str(tmp_path)):
        with pytest.raises(RuntimeError, match="materializer failed"):
            asm.unitigs(_reads())
        with profiling.annotate("after"):
            pass
    (clock,) = seen
    assert clock.name is None and clock._range is None and clock._token is None
    assert profiling._RECORDER.get() is None
    assert list(clock.stats.wall_s) == FAST_PHASES[:-1]
    spans = _ranges(tmp_path)
    top, _ = _top_level(spans)
    assert [name for name, _, _ in top] == [*FAST_PHASES, "after"]


def test_no_recorder_a_span_is_its_range_and_a_count_nothing(tmp_path):
    """Outside a run a span is its range alone, named by its step; inside
    one it is named by the phase and adds to the run's stats."""
    stats = FastAssembler(PipelineConfig(**FAST), device="cpu").unitigs(_reads())[1]
    with profiling.maybe_trace(str(tmp_path)):
        with profiling.span("step"):
            profiling.count("h2d_bytes", 5)
        with profiling.PhaseClock(stats, phase="extra"):
            with profiling.span("step"):
                profiling.count("h2d_bytes", 5)
    assert [name for name, _, _ in _ranges(tmp_path)] == [
        "step", "extra", "extra.step", "extra.h2d_bytes=5"]
    assert profiling._RECORDER.get() is None
    assert "extra.step" in stats.spans_s and "extra" in stats.wall_s


def test_counts_from_many_threads_add_up():
    """The feeder's worker counts beside the consuming thread: threads that
    run in copies of the run's context count into its one recorder, and no
    update is lost (more threads than cores, a short switch interval)."""
    import contextvars
    import sys
    import threading

    from genome_assembly_tpu_torch.models.pipeline import PhaseStats

    stats, n_threads, n_counts = PhaseStats(), 32, 2000

    def work():
        for _ in range(n_counts):
            profiling.count("h2d_bytes", 3)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.PhaseClock(stats, phase="scan"):
            threads = [threading.Thread(target=contextvars.copy_context().run, args=(work,))
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert stats.counts == {"h2d_bytes": 3 * n_threads * n_counts}


def _staged_bytes(reads, config):
    """h2d bytes of one pass over the flat batches, and of the first batch:
    the bases, unpadded, and int32 starts, int32 lengths and int64 ids a
    row, every batch padded to ``batch_reads`` rows when there are
    several."""
    rows = config["batch_reads"]
    n_batches = -(-len(reads) // rows)
    total_rows = n_batches * rows if n_batches > 1 else len(reads)
    return (sum(map(len, reads)) + total_rows * (4 + 4 + 8),
            sum(map(len, reads[:rows])) + rows * (4 + 4 + 8))


def test_copies_in_core_are_counted_exactly(monkeypatch):
    """In core the card receives each batch once and, for the device walk
    sort, the state id of each chain's head (8 bytes); it returns one byte
    a linear state and, a chain, its start, its head state and the head's
    key (24 bytes).  This genome has no cycle and no palindromic unitig, so
    every state of the kept keys is linear and each unitig is two chains,
    one a strand: the heads are the only states whose keys are gathered."""
    gathered, real_vals = [], dbg._host_state_vals

    def spy_vals(kmer, k, sids):
        gathered.append(len(sids))
        return real_vals(kmer, k, sids)
    monkeypatch.setattr(dbg, "_host_state_vals", spy_vals)
    reads = _reads()
    out, stats = FastAssembler(PipelineConfig(**FAST), device="cpu").unitigs(reads)
    staged, _ = _staged_bytes(reads, FAST)
    chains = 2 * len(out)
    assert gathered == [chains] and not any(u == dbg._rc_str(u) for u in out)
    assert stats.counts == {"h2d_bytes": staged + 8 * chains,
                            "d2h_bytes": 2 * stats.entries_post_prune + 24 * chains,
                            "on_device": 1,
                            # every batch packed once on the device
                            "packed_batches": -(-len(reads) // 32),
                            # the scan's counters: every batch's slots, 40 windows a read
                            "slots": -(-len(reads) // 32) * 32 * (128 - 21 + 1),
                            "windows": 40 * len(reads)}
    assert len(treads.batch_reads(reads, 128, 32)) > 1


def test_copies_out_of_core_are_counted(monkeypatch):
    """Out of core every pass stages every batch again (and the count's
    probe stages the first once), the kept keys go back to the card, and
    the device materializer sends the state ids whose keys it gathers (8
    bytes each): h2d is exactly that.  The kept keys parked on the host are
    read back."""
    passes, gathered = [], []
    real, real_vals = outofcore.partitioned_count, dbg._host_state_vals

    def spy(*a, **kw):
        out = real(*a, **kw)
        passes.append(out.passes)
        return out

    def spy_vals(kmer, k, sids):
        gathered.append(len(sids))
        return real_vals(kmer, k, sids)
    monkeypatch.setattr(outofcore, "partitioned_count", spy)
    monkeypatch.setattr(dbg, "_host_state_vals", spy_vals)
    reads = _reads()
    _, stats = FastAssembler(PipelineConfig(**FAST_OOC), device="cpu").unitigs(reads)
    staged, one_batch = _staged_bytes(reads, FAST_OOC)
    (n_passes,) = passes
    assert n_passes >= 1 and gathered
    kept = stats.entries_post_prune
    assert stats.counts["h2d_bytes"] == (one_batch + n_passes * staged + 8 * kept
                                         + 8 * sum(gathered))
    assert stats.counts["h2d_bytes"] >= (1 + n_passes) * one_batch
    assert stats.counts["d2h_bytes"] > 8 * kept
    # every staging of a batch packs it: the probe's, then each pass's
    assert stats.counts["packed_batches"] == 1 + n_passes * -(-len(reads) // 32)


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
    names = collections.Counter(name for name, _, _ in spans if "." not in name)
    assert names == collections.Counter(["assemble", "load", *FAST_PHASES])
    assert {name for name, _, _ in spans if "." in name and "=" not in name} == set(
        INCORE_SPANS)
    outer = next(s for s in spans if s[0] == "assemble")
    assert all(outer[1] <= s[1] and s[2] <= outer[2] for s in spans)
    record = json.loads((tmp_path / "m.jsonl").read_text())
    assert record["event"] == "assemble"
    assert list(record["phase_s"]) == FAST_PHASES
    assert sorted(record["spans_s"]) == sorted(INCORE_SPANS)
    assert set(record["counts"]) == {"h2d_bytes", "d2h_bytes", "on_device", "packed_batches",
                                     "slots", "windows", "line_table"}
    assert all(v > 0 for v in record["counts"].values())


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

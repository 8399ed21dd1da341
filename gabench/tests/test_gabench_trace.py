"""Trace readers and the metrics read from a trace, on a small synthetic
Chrome trace."""

import json
import random
import re
import time

import pytest
import torch

from conftest import REPO
from gabench import roofline, run, trace
from gabench.run import Assembly, Observed, metric_reader

PIPELINE = {"k": 31, "batch_reads": 16384, "max_read_len": 128}


def event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": 0}


def synthetic(tmp_path):
    """A window of 1000 us: load 0-200, batch 200-500, scan 500-700,
    materialize 700-1000; two K1 launches, a copy, a sort, and a kernel
    that ends after the window."""
    events = [
        event(trace.WINDOW, "user_annotation", 1000, 1000),
        event("load", "user_annotation", 1000, 200),
        event("batch", "user_annotation", 1200, 300),
        event("scan", "user_annotation", 1500, 200),
        event("materialize", "user_annotation", 1700, 300),
        event("fast_scan_kernel(unsigned char const*, int)", "kernel", 1510, 40),
        event("fast_scan_kernel(unsigned char const*, int)", "kernel", 1560, 60),
        event("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1500, 20),
        event("DeviceRadixSortOnesweepKernel", "kernel", 1650, 30),
        event("late_kernel", "kernel", 1990, 50),
        event("aten::sort", "cpu_op", 1640, 5),
        {"ph": "i", "name": "marker", "ts": 1000},
    ]
    path = tmp_path / "trace_1_2.json"
    path.write_text(json.dumps({"traceEvents": events}))
    device, ranges, size = trace.read_trace(tmp_path)
    assert size == path.stat().st_size
    return trace.Trace(device, ranges)


def test_interval_union_and_busy_share():
    assert trace.interval_union([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.busy_share([(0, 2), (1, 3), (5, 6)], 1, 5) == 0.5


def test_trace_reductions(tmp_path):
    t = synthetic(tmp_path)
    assert (t.lo, t.hi) == (1000.0, 2000.0)
    assert t.window_s() == pytest.approx(1e-3)
    # 1500-1550, 1560-1620, 1650-1680, 1990-2000 (clipped)
    assert t.busy_s() == pytest.approx(150e-6)
    assert t.kernel_seconds("fast_scan_kernel") == (2, pytest.approx(100e-6))
    ops = t.top_device_ops()
    assert ops[0] == ["fast_scan_kernel(unsigned char const*, int)", pytest.approx(100e-6)]
    assert [name for name, _ in ops] == [
        "fast_scan_kernel(unsigned char const*, int)", "DeviceRadixSortOnesweepKernel",
        "Memcpy HtoD (Pinned -> Device)", "late_kernel"]
    gaps = t.idle_gaps()
    # 1000-1500 cut at 1200 where load ends and batch begins, 1680-1990 cut
    # at 1700 where scan ends and materialize begins, 1620-1650, 1550-1560
    assert gaps == [["batch", pytest.approx(300e-6)], ["materialize", pytest.approx(290e-6)],
                    ["load", pytest.approx(200e-6)], ["scan", pytest.approx(30e-6)],
                    ["scan", pytest.approx(20e-6)], ["scan", pytest.approx(10e-6)]]
    assert sum(s for _, s in gaps) == pytest.approx(t.window_s() - t.busy_s())


def observed(t, wall_s=None):
    return Observed(config={"pipeline": PIPELINE}, setup_s=30.0,
                    window_s=20.0, assemblies=[Assembly(1.0, 10.0, wall_s or {}),
                                               Assembly(3.0, 10.0, wall_s or {})],
                    peak_device_bytes=3 << 30, trace=t)


def test_metrics_read_from_the_trace(tmp_path):
    t = synthetic(tmp_path)
    idle = metric_reader(REPO, "device_idle_pct")
    assert idle(observed(t)) == pytest.approx(85.0)
    assert idle(observed(None)) is None
    roof = metric_reader(REPO, "scan_roofline_pct")
    bound = 2 * roofline.scan_bytes(16384, 128, 31) / roofline.PEAK_BYTES_PER_S
    assert roof(observed(t)) == pytest.approx(100 * bound / 100e-6)
    assert roof(observed(None)) is None


def test_a_trace_without_device_activity_reads_nothing(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [event(trace.WINDOW, "user_annotation", 0, 10)]}))
    t = trace.Trace(*trace.read_trace(tmp_path)[:2])
    assert metric_reader(REPO, "device_idle_pct")(observed(t)) is None
    assert metric_reader(REPO, "scan_roofline_pct")(observed(t)) is None
    assert t.idle_gaps() == [[trace.WINDOW, pytest.approx(1e-5)]]


def test_metrics_read_from_the_phases_and_the_window():
    wall = {"batch": 4.0, "scan": 0.25, "count": 0.5, "links": 0.1, "jump": 0.2,
            "materialize": 5.0}
    o = observed(None, wall)
    read = {name: metric_reader(REPO, name)(o) for name in (
        "assemble_s", "peak_device_gib", "setup_s", "load_s", "batch_s", "scan_s", "count_s",
        "extension_s", "materialize_s")}
    assert read == {"assemble_s": 10.0, "peak_device_gib": 3.0, "setup_s": 30.0, "load_s": 2.0,
                    "batch_s": 4.0, "scan_s": 0.25, "count_s": 0.5,
                    "extension_s": pytest.approx(0.3), "materialize_s": 5.0}
    del wall["scan"]
    assert metric_reader(REPO, "scan_s")(observed(None, wall)) is None


def quadratic_idle_gaps(t, n=10):
    """``Trace.idle_gaps`` as it was before it became one sweep, frozen here
    as the measure of the sweep: every stretch scans every cut."""
    spans = [(max(a, t.lo), min(b, t.hi))
             for kind in trace.DEVICE_EVENT_KINDS for _, a, b in t.device_events[kind]
             if b > t.lo and a < t.hi]
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    edges = [t.lo] + [x for span in merged for x in span] + [t.hi]
    cuts = sorted({x for name, a, b in t.ranges if name != trace.WINDOW for x in (a, b)
                   if t.lo < x < t.hi})
    gaps = []
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        inside = [x for x in cuts if a < x < b]
        gaps += [(x, y) for x, y in zip([a] + inside, inside + [b]) if y > x]
    gaps.sort(key=lambda g: g[0] - g[1])
    return [[quadratic_enclosing(t, (a + b) / 2), (b - a) / 1e6] for a, b in gaps[:n]]


def quadratic_enclosing(t, x):
    inside = [(b - a, name) for name, a, b in t.ranges if a <= x <= b and name != trace.WINDOW]
    return min(inside)[1] if inside else trace.WINDOW


PHASES = ("load", "batch", "scan", "count", "links", "jump", "materialize")


def random_trace(seed):
    """A window with device spans and host ranges drawn from one pool of
    times, so that spans overlap and touch and cuts fall on span edges;
    spans and ranges that cross the window's ends; zero-length counter
    ranges; and, every fifth seed, no device activity in the window."""
    rng = random.Random(seed)
    lo = rng.choice([0.0, 1000.0, 1234567.891])
    hi = lo + rng.choice([50.0, 1000.0, 12345.678])
    pool = sorted({rng.choice([round(rng.uniform(lo - 40, hi + 40), 3),
                               float(rng.randint(int(lo) - 40, int(hi) + 40))])
                   for _ in range(rng.randint(5, 120))} | {lo, hi})

    def interval():
        a, b = sorted(rng.sample(pool, 2)) if len(pool) > 1 else (pool[0], pool[0])
        return (a, a) if rng.random() < 0.1 else (a, b)

    device = {kind: [] for kind in trace.DEVICE_EVENT_KINDS}
    quiet = seed % 5 == 0
    for _ in range(rng.randint(0, 80)):
        a, b = interval()
        if quiet and b > lo and a < hi:
            continue
        device[rng.choice(trace.DEVICE_EVENT_KINDS)].append((f"k{rng.randint(0, 5)}", a, b))
    ranges = [(trace.WINDOW, lo, hi)]
    for _ in range(rng.randint(0, 60)):
        phase = rng.choice(PHASES)
        a, b = interval()
        if rng.random() < 0.3:
            ranges.append((f"{phase}.{rng.choice(['h2d_bytes', 'slots'])}={rng.randint(1, 9)}",
                           b, b))
        else:
            ranges.append((rng.choice([phase, f"{phase}.step"]), a, b))
    rng.shuffle(ranges)
    return trace.Trace(device, ranges)


@pytest.mark.parametrize("seed", range(24))
def test_idle_gaps_equal_the_quadratic_form(seed):
    t = random_trace(seed)
    for n in (10, 10**9):
        assert t.idle_gaps(n) == quadratic_idle_gaps(t, n)
    if seed % 5 == 0:
        assert not t.device_spans()
        assert sum(s for _, s in t.idle_gaps(10**9)) == pytest.approx(t.window_s())


def test_the_random_traces_hold_each_case():
    """Across the seeds: overlapping and touching spans, cuts on span edges,
    counter ranges, spans clipped at both ends, windows with no activity."""
    seen = set()
    for seed in range(24):
        t = random_trace(seed)
        raw = sorted((a, b) for kind in trace.DEVICE_EVENT_KINDS
                     for _, a, b in t.device_events[kind] if b > t.lo and a < t.hi)
        seen |= {"overlap" for (_, b), (a, _) in zip(raw, raw[1:]) if a < b}
        seen |= {"touch" for (_, b), (a, _) in zip(raw, raw[1:]) if a == b}
        edges = {x for span in raw for x in span}
        seen |= {"cut on edge" for name, a, b in t.ranges
                 if name != trace.WINDOW and ({a, b} & edges)}
        seen |= {"counter" for name, a, b in t.ranges if "=" in name and a == b}
        seen |= {"clipped low" for a, _ in raw if a < t.lo}
        seen |= {"clipped high" for _, b in raw if b > t.hi}
        seen |= {"no activity"} if not raw else set()
    assert seen == {"overlap", "touch", "cut on edge", "counter", "clipped low", "clipped high",
                    "no activity"}


def test_idle_gaps_of_a_large_trace_take_seconds():
    """650,000 device spans and 18,000 host ranges (the quadratic form took
    about twelve minutes on such a trace)."""
    rng = random.Random(23)
    lo, hi = 0.0, 153e6
    starts = sorted(rng.uniform(lo, hi) for _ in range(650_000))
    kernels = [("k", a, a + rng.uniform(0.5, 60.0)) for a in starts]
    device = {kind: [] for kind in trace.DEVICE_EVENT_KINDS}
    device["kernel"] = kernels
    ranges = [(trace.WINDOW, lo, hi)]
    for _ in range(18_000):
        a = rng.uniform(lo, hi)
        ranges.append((rng.choice(PHASES), a, a + rng.uniform(0.0, 2e5)))
    t = trace.Trace(device, ranges)
    began = time.perf_counter()
    gaps = t.idle_gaps()
    busy = t.busy_s()
    assert time.perf_counter() - began < 30.0
    assert len(gaps) == 10 and 0 < busy < t.window_s()
    assert [s for _, s in gaps] == sorted((s for _, s in gaps), reverse=True)
    assert {name for name, _ in gaps} <= set(PHASES) | {trace.WINDOW}


def test_the_device_spans_are_made_once():
    t = random_trace(1)
    assert t.device_spans() is t.device_spans()


def test_a_capture_without_a_card_writes_one_trace(tmp_path):
    """The harness's own capture, on the CPU: one Chrome trace holding the
    window's range and the host's operator calls, read without a card's
    refusal."""
    with run.capture(on_card=False) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            with torch.profiler.record_function("load"):
                torch.arange(1000).sum()
    run.export(prof, str(tmp_path))
    assert len(list(tmp_path.glob("*.json"))) == 1
    t = run.read_capture(str(tmp_path), on_card=False)
    assert t.hi > t.lo and [name for name, *_ in t.ranges if name == "load"] == ["load"]
    assert not t.device_spans()


def test_a_card_trace_without_device_activity_is_refused(tmp_path):
    """A run on a card whose trace holds no kernel, copy or set: the file
    ``read_trace`` is handed has host events alone."""
    events = [event(trace.WINDOW, "user_annotation", 0, 10), event("aten::sum", "cpu_op", 2, 3),
              event("load", "user_annotation", 1, 5)]
    (tmp_path / "trace_1_2.json").write_text(json.dumps({"traceEvents": events}))
    with pytest.raises(RuntimeError, match=re.escape(run.NO_DEVICE_ACTIVITY)):
        run.read_capture(str(tmp_path), on_card=True)
    assert run.read_capture(str(tmp_path), on_card=False).window_s() == pytest.approx(1e-5)
    events.append(event("fast_scan_kernel", "kernel", 3, 1))
    (tmp_path / "trace_1_2.json").write_text(json.dumps({"traceEvents": events}))
    assert run.read_capture(str(tmp_path), on_card=True).busy_s() == pytest.approx(1e-6)


def test_a_card_without_cupti_is_refused(monkeypatch):
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match=re.escape(run.NO_CUPTI)):
        run.capture(on_card=True)
    run.capture(on_card=False)


def test_a_traced_run_never_builds_the_event_tree(bench_copy, monkeypatch, capsys):
    """The profiler's event tree (``events()``, ``key_averages()``) is never
    built in a traced run; each step after the window is written to stderr
    and ``window.post_s`` holds their sum."""
    def refuse(self):
        raise AssertionError("the profiler's event tree was built")
    monkeypatch.setattr(torch.autograd.profiler.profile, "_ensure_function_events", refuse)
    result = run.run_cell(bench_copy, "tiny.cov20", 2**31 + 4245, 0.3, True, torch.device("cpu"))
    assert result["correct"] is True and result["breakdown"]["idle_gaps"]
    steps = [line.split()[4] for line in capsys.readouterr().err.splitlines()
             if line.startswith("gabench: after the window, ")]
    assert steps == ["capture", "export", "read_trace", "readers", "breakdown", "free", "judge"]
    window = result["window"]
    assert 0 < window["judge_s"] <= window["post_s"]

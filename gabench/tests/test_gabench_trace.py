"""Trace readers and the metrics read from a trace, on a small synthetic
Chrome trace."""

import json

import pytest

from conftest import REPO
from gabench import roofline, trace
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

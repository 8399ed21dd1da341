"""Profiler hooks on ``torch.profiler`` (the CLI's ``--trace DIR``) and the
one recorder of a run's phases, steps and counters.

``maybe_trace(dir)`` records the host's operator calls and, where a CUDA
device is present, the card's kernels, copies and sets, and writes them on
exit as one Chrome-trace JSON file in ``dir`` (Perfetto, chrome://tracing
and TensorBoard's PyTorch plugin read it; the JAX package writes XPlane).
``annotate(name)`` marks a named range in that timeline, and on a machine
with a CUDA device it is also an NVTX range of the same name, so Nsight
Systems sees the pipeline's phases too.

A trace taken where a card is present must hold the card's activity: if
the profiler cannot record it (no CUPTI) or recorded none, ``maybe_trace``
raises instead of writing a host-only trace.

``PhaseClock`` times the phases of one run into its ``PhaseStats``
(models/pipeline.py).  While it is open it is the active recorder, held in
a context variable, so code anywhere below the run reports to it:
``span(step)`` times a step of the phase in progress as ``<phase>.<step>``
(one ``annotate`` range, its seconds summed into ``spans_s``) and
``count(name, n)`` adds to the run's counter ``name`` (``counts``).  With
no open clock (ops called directly, the tools, the tests) a span is only
its range, named by the step, and a count does nothing.  Neither ever
synchronizes a device or reads anything back: a span over device work
ends where the step's own code first waits for it.  While a trace is
being recorded, a phase that counted something ends with one zero-length
range a counter, ``<phase>.<counter>=<n>``, so the trace carries the
counts beside the spans (the benchmark's readers find both there).
"""

from __future__ import annotations

import contextvars
import os
import pathlib
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, Optional

import torch


def _device_events(prof) -> int:
    """Events of the trace that ran on a CUDA device."""
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


@contextmanager
def maybe_trace(trace_dir: Optional[str], cuda: Optional[bool] = None) -> Iterator[None]:
    """Capture a trace into trace_dir when set; no-op otherwise.  The file
    is ``trace_<pid>_<ns>.json`` (written when the block ends without an
    exception).  ``cuda``: record the card's activity (default: when a CUDA
    device is present; a run asked onto the CPU passes False)."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, supported_activities

    activities = [ProfilerActivity.CPU]
    on_card = torch.cuda.is_available() if cuda is None else cuda
    if on_card:
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError(
                "maybe_trace: a CUDA device is present but torch.profiler cannot "
                "record CUDA activity (no CUPTI); refusing a host-only trace")
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    if on_card and not _device_events(prof):
        raise RuntimeError(
            "maybe_trace: the profiler recorded no CUDA activity on a machine "
            "with a CUDA device; refusing a host-only trace")
    prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named range in the trace timeline (and an NVTX range on a machine
    with a CUDA device)."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


_RECORDER: contextvars.ContextVar[Optional["PhaseClock"]] = contextvars.ContextVar(
    "genome_assembly_tpu_torch_recorder", default=None)


class PhaseClock:
    """Times the phases of one run into ``stats.wall_s``, its steps into
    ``stats.spans_s`` and its counters into ``stats.counts``.

    ``start(name)`` ends the phase in progress and begins ``name``,
    ``stop()`` ends the last.  Ending a phase first synchronizes every CUDA
    device the clock was given, so its seconds hold its device work.  Each
    phase is one range of its name in a trace (``annotate``).  The clock is
    the active recorder from its making until ``close()``; use it as a
    context manager, whose exit closes it: after an exception the phase in
    progress ends without a synchronize or a reading, so no range stays
    open and no recorder stays active."""

    def __init__(self, stats, *devices: torch.device, phase: Optional[str] = None):
        self.stats = stats
        self.devices = {torch.device(d) for d in devices}
        self.name = self._range = None
        self._counted: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._token = _RECORDER.set(self)
        if phase is not None:
            self.start(phase)

    def __enter__(self) -> "PhaseClock":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(ok=exc_type is None)

    def start(self, name: str) -> None:
        self.stop()
        self._range = annotate(name)
        self._range.__enter__()
        self.name = name
        self._counted = dict(self.stats.counts)
        self.t = time.perf_counter()

    def stop(self) -> None:
        if self.name is None:
            return
        for device in self.devices:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        now = time.perf_counter()
        self.stats.wall_s[self.name] = self.stats.wall_s.get(self.name, 0.0) + now - self.t
        if torch.autograd.profiler._is_profiler_enabled:
            for counter, n in self.stats.counts.items():
                if n != self._counted.get(counter, 0):
                    with torch.profiler.record_function(
                            f"{self.name}.{counter}={n - self._counted.get(counter, 0)}"):
                        pass
        self._end_phase()

    def close(self, ok: bool = True) -> None:
        """End the phase in progress (timed when ``ok``) and stop being the
        active recorder.  Idempotent."""
        try:
            if ok:
                self.stop()
        finally:
            self._end_phase()
            if self._token is not None:
                _RECORDER.reset(self._token)
                self._token = None

    def _end_phase(self) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
        self.name = self._range = None

    def add_span(self, name: str, seconds: float) -> None:
        spans = self.stats.spans_s
        spans[name] = spans.get(name, 0.0) + seconds

    def add_count(self, name: str, n: int) -> None:
        # the feeder's worker thread counts too
        with self._lock:
            self.stats.counts[name] = self.stats.counts.get(name, 0) + n


@contextmanager
def span(step: str) -> Iterator[None]:
    """Time ``step`` of the active recorder's phase in progress as
    ``<phase>.<step>`` (one ``annotate`` range; seconds summed into its
    ``spans_s``).  With no recorder: the range alone, named ``step``."""
    recorder = _RECORDER.get()
    phase = None if recorder is None else recorder.name
    name = step if phase is None else f"{phase}.{step}"
    with annotate(name):
        t = time.perf_counter()
        yield
        if recorder is not None:
            recorder.add_span(name, time.perf_counter() - t)


def count(name: str, n: int) -> None:
    """Add ``n`` (a host int, such as an array's ``nbytes``: never a device
    value) to the active recorder's counter ``name``; nothing without a
    recorder."""
    recorder = _RECORDER.get()
    if recorder is not None:
        recorder.add_count(name, n)

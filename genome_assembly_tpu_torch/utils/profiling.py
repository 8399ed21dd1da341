"""Profiler hooks on ``torch.profiler``: the CLI's ``--trace DIR``.

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
"""

from __future__ import annotations

import os
import pathlib
import time
from contextlib import contextmanager
from typing import Iterator, Optional

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

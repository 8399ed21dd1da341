"""Structured per-phase metrics (SURVEY.md section 5.5).

The reference has no observability beyond two debug printers; here every
pipeline phase emits a JSONL record: wall time, entry counts, throughput,
routing bytes.  Consumed by humans, the plotting harness, and the scaling
benchmark.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional, TextIO


class MetricsLogger:
    """Append JSONL metric records; no-op when sink is None."""

    def __init__(self, sink: Optional[TextIO] = None, run_id: str = ""):
        self.sink = sink
        self.run_id = run_id
        self._t0 = time.time()

    def emit(self, event: str, **fields: Any) -> Dict[str, Any]:
        rec = {
            "ts": round(time.time() - self._t0, 6),
            "run": self.run_id,
            "event": event,
            **fields,
        }
        if self.sink is not None:
            self.sink.write(json.dumps(rec) + "\n")
            self.sink.flush()
        return rec

    @contextmanager
    def phase(self, name: str, **fields: Any) -> Iterator[Dict[str, Any]]:
        """Time a phase; emits '<name>' with wall_s on exit.  Extra fields
        can be added to the yielded dict inside the block."""
        extra: Dict[str, Any] = {}
        t0 = time.perf_counter()
        try:
            yield extra
        finally:
            self.emit(
                name, wall_s=round(time.perf_counter() - t0, 6), **fields, **extra
            )


def open_metrics(path: Optional[str], run_id: str = "") -> MetricsLogger:
    if path is None:
        return MetricsLogger(None, run_id)
    return MetricsLogger(open(path, "a"), run_id)

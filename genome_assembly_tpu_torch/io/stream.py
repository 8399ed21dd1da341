"""Double-buffered host -> device batch feeding.

A worker thread stages the NEXT batches' host -> device copies while the
device computes on the current one.  Order is kept; at most ``depth``
batches are staged; an exception in the worker is raised at the consuming
end; and a consumer that abandons the iteration (or leaves its ``with``
block, or calls ``close()``) stops the worker, which then releases its
staged batches instead of blocking forever.

On a CUDA device a batch is staged through a ring of ``depth`` pinned host
buffers (allocated once, refilled only after the copy that read a buffer
has completed) and copied on a side stream; the consumer's stream waits on
that copy's event before it uses the batch, and each delivered tensor is
recorded on the consumer's stream, so the caching allocator does not hand
its memory back while the consumer still reads it.

The worker runs in the caller's context, so the run in progress
(``utils/profiling``) counts what it stages: ``h2d_bytes``, every batch's
bytes, on a card and on the CPU alike.  The consumer's wait for a staged
batch is the span ``wait`` of the phase in progress.
"""

from __future__ import annotations

import contextvars
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, Sequence

import torch

from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.utils import profiling


class DeviceFeeder:
    """Iterate device-resident batches with transfer/compute overlap.

    items: any iterable of host batches.
    stage: host batch -> staged batch; runs on the worker thread.
    receive: staged batch -> what the consumer gets; runs on the consuming
      thread as each batch is handed over (default: the staged batch).
    depth: max staged batches (2 = classic double buffering).

    Supports the context-manager protocol; ``close()`` (or leaving the
    ``with`` block, or garbage collection of an abandoned feeder) signals
    the worker to stop staging and drains the queue so the thread exits
    promptly rather than leaking itself plus ``depth`` device batches.
    """

    _DONE = object()

    def __init__(
        self,
        items: Iterable,
        stage: Callable,
        *,
        depth: int = 2,
        receive: Optional[Callable] = None,
    ) -> None:
        # the worker holds the queue, the stop flag and the error box, never
        # the feeder: an abandoned feeder is collected, and its __del__
        # stops the worker, which then drops what it staged
        self._q = q = queue.Queue(maxsize=max(1, depth))
        self._stop = stop = threading.Event()
        self._errors = errors = []
        self._receive = receive

        def put(item) -> None:
            # timed puts, so a stopped consumer is noticed even when the
            # queue stays full (the consumer stopped draining)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def work() -> None:
            try:
                for it in items:
                    put(stage(it))
                    if stop.is_set():
                        return
            except BaseException as e:  # surfaced on the consumer side
                errors.append(e)
            finally:
                # DONE must actually arrive (a dropped marker deadlocks the
                # consumer)
                put(DeviceFeeder._DONE)
        self._thread = threading.Thread(target=contextvars.copy_context().run, args=(work,),
                                        daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return

    def close(self) -> None:
        """Stop the worker and release staged batches (idempotent)."""
        self._stop.set()
        # drain whatever is staged so the worker's pending put unblocks,
        # and again once it has exited (it may have put one more)
        self._drain()
        self._thread.join(timeout=5.0)
        self._drain()

    def __enter__(self) -> "DeviceFeeder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:  # backstop for abandoned feeders
        self._stop.set()

    def __iter__(self) -> Iterator:
        while True:
            with profiling.span("wait"):
                item = self._q.get()
            if item is self._DONE:
                self._thread.join()
                if self._errors:
                    raise self._errors[0]
                return
            yield item if self._receive is None else self._receive(item)
            del item


class _PinnedRing:
    """Copies read batches to one CUDA device through ``depth`` pinned host
    buffers used in turn, on a side stream.  A buffer is refilled only after
    the copy that last read it has completed (its event); a batch larger
    than its buffer (a different width, more rows) gets a larger one.
    Returns (tensors, event) for ``_receive``."""

    def __init__(self, device: torch.device, depth: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slots = [None] * max(1, depth)  # (pinned codes, lengths, ids, event)
        self.turn = 0

    def _slot(self, n: int, width: int):
        i = self.turn
        self.turn = (i + 1) % len(self.slots)
        slot = self.slots[i]
        if slot is not None:
            slot[3].synchronize()  # the copy that read this buffer is done
        if slot is None or slot[0].shape[1] != width or slot[0].shape[0] < n:
            slot = (torch.empty((n, width), dtype=torch.uint8, pin_memory=True),
                    torch.empty(n, dtype=torch.int32, pin_memory=True),
                    torch.empty(n, dtype=torch.int64, pin_memory=True),
                    torch.cuda.Event())
            self.slots[i] = slot
        return slot

    def __call__(self, batch):
        host = _host_batch(batch)
        n, width = host[0].shape
        *pinned, event = self._slot(n, width)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = []
            for buf, h in zip(pinned, host):
                buf = buf[:n]
                buf.copy_(h)
                out.append(torch.empty_like(buf, device=self.device).copy_(buf, non_blocking=True))
            event.record(self.stream)
        return tuple(out), event


def _host_batch(batch):
    """A read batch as CPU tensors (``convert.read_batch_to_torch``), its
    bytes counted as ``h2d_bytes``: what staging it copies to the device."""
    host = convert.read_batch_to_torch(batch)
    profiling.count("h2d_bytes", sum(t.nbytes for t in host))
    return host


def _receive(staged):
    """The consumer's side of a ``_PinnedRing`` copy: its current stream
    waits for the copy, and owns the tensors from here on."""
    tensors, event = staged
    consumer = torch.cuda.current_stream(tensors[0].device)
    consumer.wait_event(event)
    for t in tensors:
        t.record_stream(consumer)
    return tensors


def batch_stager(device="cuda", depth: int = 1):
    """(stage, receive) that copy ``io.reads.ReadBatch`` batches to
    ``device`` as (codes uint8 [n, L], lengths int32 [n], read_ids int64
    [n]) tensors: on a CUDA device through a ring of ``depth`` pinned
    buffers and a side stream, on the CPU as tensors over the arrays.
    Raises on a CUDA device where there is none."""
    device = torch.device(device)
    if device.type != "cuda":
        return _host_batch, None
    if not torch.cuda.is_available():
        raise RuntimeError("feed_read_batches was asked for a CUDA device and this machine "
                           "has none; pass device='cpu' to run on the CPU")
    return _PinnedRing(device, depth), _receive


def feed_read_batches(batches: Sequence, device="cuda", *, depth: int = 2) -> DeviceFeeder:
    """Stage ``io.reads.ReadBatch`` batches onto ``device`` in order.

    Returns the DeviceFeeder itself (iterable AND a context manager) so
    call sites can wrap consumption in ``with`` and guarantee the worker
    exits when the consuming loop raises.
    """
    stage, receive = batch_stager(device, depth)
    return DeviceFeeder(batches, stage, depth=depth, receive=receive)

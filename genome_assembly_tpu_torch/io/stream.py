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

Two kinds of batch, each on its own route, chosen by its type: an
``io.reads.ReadBatch`` (padded, encoded rows) is copied as it is; an
``io.reads.FlatBatch`` (fast mode's bases, unpadded) is copied with its
reads' starts among them, their lengths and its ids, and ``ops/pack_rows``
builds its rows where it was copied to: on a card on the side stream,
before the copy's event.  Either way the consumer gets (codes uint8
[n, L], lengths int32 [n], read_ids int64 [n]).

The worker runs in the caller's context, so the run in progress
(``utils/profiling``) counts what it stages: ``h2d_bytes``, every batch's
bytes as they are copied, and ``packed_batches``, every flat batch packed,
on a card and on the CPU alike.  The consumer's wait for a staged batch is
the span ``wait`` of the phase in progress.
"""

from __future__ import annotations

import contextvars
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, Sequence

import torch

from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.io.reads import FlatBatch
from genome_assembly_tpu_torch.ops import pack_rows
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
    buffers used in turn, on a side stream, where a flat batch is then
    packed.  A buffer is refilled only after the work that last read it has
    completed (its event); a batch larger than its buffer (a different
    width, more rows) gets a larger one.  The packer's 256-byte table is
    copied once a ring, from pinned memory on the side stream, without
    synchronising (not counted).  Returns (tensors,
    event) for ``_receive``."""

    def __init__(self, device: torch.device, depth: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slots = [None] * max(1, depth)  # ([pinned buffers], event)
        self.turn = 0
        self.table = None

    def _slot(self, sizes):
        """The next pinned buffers, one at least of each (shape, dtype)."""
        i = self.turn
        self.turn = (i + 1) % len(self.slots)
        slot = self.slots[i]
        if slot is not None:
            slot[1].synchronize()  # the work that read these buffers is done
        if slot is None or len(slot[0]) != len(sizes) or not all(
                b.dtype == dtype and b.shape[1:] == shape[1:] and b.shape[0] >= shape[0]
                for b, (shape, dtype) in zip(slot[0], sizes)):
            slot = ([torch.empty(shape, dtype=dtype, pin_memory=True) for shape, dtype in sizes],
                    torch.cuda.Event())
            self.slots[i] = slot
        return slot

    def _copy(self, pinned, host):
        """Device copies of the host arrays through the pinned buffers, on
        the current (side) stream."""
        out = []
        for buf, h in zip(pinned, host):
            buf = buf[:len(h)]
            buf.numpy()[...] = h
            out.append(torch.empty_like(buf, device=self.device).copy_(buf, non_blocking=True))
        return out

    def __call__(self, batch):
        if isinstance(batch, FlatBatch):
            host = _flat_host(batch)
            n = batch.n
            # the bases' buffer holds any batch of these rows
            sizes = [((max(n * batch.width, len(host[0])),), torch.uint8), ((n,), torch.int32),
                     ((n,), torch.int32), ((n,), torch.int64)]
        else:
            host = _host_batch(batch)
            sizes = [(h.shape, h.dtype) for h in host]
            host = [h.numpy() for h in host]
        pinned, event = self._slot(sizes)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = self._copy(pinned, host)
            if isinstance(batch, FlatBatch):
                if self.table is None:
                    self.table = pack_rows.ascii_table(self.device)
                out = _pack(*out, self.table, batch.width)
            event.record(self.stream)
        return tuple(out), event


def _host_batch(batch):
    """A read batch as CPU tensors (``convert.read_batch_to_torch``), its
    bytes counted as ``h2d_bytes``: what staging it copies to the device."""
    host = convert.read_batch_to_torch(batch)
    profiling.count("h2d_bytes", sum(t.nbytes for t in host))
    return host


def _flat_host(batch: FlatBatch):
    """A flat batch as the arrays staging it copies (bases uint8, starts
    and lengths int32, read_ids int64), their bytes counted as
    ``h2d_bytes``."""
    host = (batch.bases, batch.starts, batch.lengths, batch.read_ids)
    profiling.count("h2d_bytes", sum(a.nbytes for a in host))
    return host


def _pack(bases, starts, lengths, read_ids, table, width: int):
    """(codes, lengths, read_ids) of a flat batch on the bases' device,
    counted as ``packed_batches``."""
    codes = pack_rows.pack_rows_plain(bases, starts, lengths, table, width)
    profiling.count("packed_batches", 1)
    return codes, lengths, read_ids


def _stage_on_host(batch):
    """The CPU's staging: a read batch as tensors, a flat one packed (its
    arrays copied, as staging on a card copies them)."""
    if isinstance(batch, FlatBatch):
        host = (torch.from_numpy(a.copy()) for a in _flat_host(batch))
        return _pack(*host, pack_rows.ascii_table("cpu"), batch.width)
    return _host_batch(batch)


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
    """(stage, receive) that copy ``io.reads.ReadBatch`` or ``FlatBatch``
    batches to ``device`` as (codes uint8 [n, L], lengths int32 [n],
    read_ids int64 [n]) tensors: on a CUDA device through a ring of
    ``depth`` pinned buffers and a side stream, on the CPU as tensors over
    the arrays (a flat batch packed there).  Raises on a CUDA device where
    there is none."""
    device = torch.device(device)
    if device.type != "cuda":
        return _stage_on_host, None
    if not torch.cuda.is_available():
        raise RuntimeError("feed_read_batches was asked for a CUDA device and this machine "
                           "has none; pass device='cpu' to run on the CPU")
    return _PinnedRing(device, depth), _receive


def feed_read_batches(batches: Sequence, device="cuda", *, depth: int = 2) -> DeviceFeeder:
    """Stage ``io.reads.ReadBatch`` or ``FlatBatch`` batches onto
    ``device`` in order.

    Returns the DeviceFeeder itself (iterable AND a context manager) so
    call sites can wrap consumption in ``with`` and guarantee the worker
    exits when the consuming loop raises.
    """
    stage, receive = batch_stager(device, depth)
    return DeviceFeeder(batches, stage, depth=depth, receive=receive)

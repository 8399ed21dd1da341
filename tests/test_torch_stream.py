"""The port's threaded ``DeviceFeeder`` (io/stream.py), held to the JAX
package's contract (``tests/test_utils.py``'s feeder cases, run against the
port's class): order is kept, a worker's exception is raised at the
consumer, and close(), ``with`` and an abandoned consumer stop the worker
and release what it staged.  ``feed_read_batches`` on the CPU gives the
read batches as tensors, in order, a lone shorter batch included.  The
card's pinned-ring staging runs in ``chip_smoke.py`` (``surfaces_e2e``)."""

import gc
import threading
import time

import numpy as np
import pytest
import torch

from genome_assembly_tpu.io.stream import DeviceFeeder as JFeeder
from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.io import reads as treads
from genome_assembly_tpu_torch.io import stream as tstream
from genome_assembly_tpu_torch.io.stream import DeviceFeeder


def _stopped(feeder, timeout=5.0):
    deadline = time.time() + timeout
    while feeder._thread.is_alive() and time.time() < deadline:
        time.sleep(0.01)
    return not feeder._thread.is_alive()


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_feeder_order_and_errors_match_jax(depth):
    out = list(DeviceFeeder(range(10), lambda x: x * 2, depth=depth))
    assert out == list(JFeeder(range(10), lambda x: x * 2, depth=depth)) == [
        x * 2 for x in range(10)]

    def boom(x):
        if x == 3:
            raise ValueError("staged failure")
        return x

    got = []
    with pytest.raises(ValueError, match="staged failure"):
        for x in DeviceFeeder(range(5), boom, depth=depth):
            got.append(x)
    assert got == [0, 1, 2]


def test_feeder_bounds_what_it_stages():
    """At most ``depth`` batches wait in the queue, one more in the worker's
    hand: the worker is held back while the consumer does not take."""
    staged = []
    feeder = DeviceFeeder(range(100), lambda x: (staged.append(x), x)[1], depth=2)
    it = iter(feeder)
    assert next(it) == 0
    time.sleep(0.3)
    assert len(staged) <= 1 + 2 + 1
    assert list(it) == list(range(1, 100))
    feeder.close()
    assert _stopped(feeder)


def test_feeder_receive_runs_on_the_consuming_thread():
    seen = []

    def receive(x):
        seen.append(threading.current_thread() is threading.main_thread())
        return -x
    assert list(DeviceFeeder(range(4), lambda x: x, receive=receive)) == [0, -1, -2, -3]
    assert seen == [True] * 4


def test_feeder_abandoned_consumer_stops_worker():
    feeder = DeviceFeeder(range(1000), lambda x: x, depth=2)
    it = iter(feeder)
    next(it)  # consume one, then abandon (as a raising consumer does)
    feeder.close()
    assert _stopped(feeder)
    assert feeder._q.qsize() == 0  # nothing staged is kept alive

    # context-manager form: leaving the block mid-iteration also stops it
    with DeviceFeeder(range(1000), lambda x: x, depth=2) as f2:
        next(iter(f2))
    assert _stopped(f2) and f2._q.qsize() == 0

    # a consumer that raises inside the block
    with pytest.raises(RuntimeError, match="consumer"):
        with DeviceFeeder(range(1000), lambda x: x, depth=3) as f3:
            for x in f3:
                if x == 2:
                    raise RuntimeError("consumer failed")
    assert _stopped(f3) and f3._q.qsize() == 0


def test_feeder_dropped_without_close_stops_worker():
    """A consumer that breaks off and drops the feeder, without close() or
    ``with``: the worker holds no reference to the feeder, so the feeder is
    collected, its __del__ stops the worker, and what it staged goes."""
    released = []

    class Batch:
        def __del__(self):
            released.append(1)

    staged = []

    def stage(x):
        staged.append(1)
        return Batch()

    feeder = DeviceFeeder(range(1000), stage, depth=2)
    thread = feeder._thread
    for i, _ in enumerate(feeder):
        if i == 2:
            break
    del feeder, _
    gc.collect()
    thread.join(timeout=5.0)
    assert not thread.is_alive()
    gc.collect()
    assert len(staged) < 1000 and len(released) == len(staged)


def _batches(n_reads, rows, seed=0):
    rng = np.random.default_rng(seed)
    reads = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(20, 60))))
             for _ in range(n_reads)]
    return treads.batch_reads(reads, 64, rows)


@pytest.mark.parametrize("n_reads,rows", [(70, 16), (5, 16), (64, 16)])
def test_feed_read_batches_on_the_cpu(n_reads, rows):
    """Each batch as convert.read_batch_to_torch gives it, in order (the last
    one shorter, or a lone short batch)."""
    batches = _batches(n_reads, rows)
    with tstream.feed_read_batches(batches, "cpu") as feeder:
        got = list(feeder)
    assert len(got) == len(batches)
    for (codes, lengths, rids), b in zip(got, batches):
        want = convert.read_batch_to_torch(b)
        assert codes.dtype == torch.uint8 and lengths.dtype == torch.int32
        assert rids.dtype == torch.int64
        for x, y in zip((codes, lengths, rids), want):
            assert torch.equal(x, y)
    assert _stopped(feeder)


def test_batch_stager_on_the_cpu_is_the_plain_conversion():
    stage, receive = tstream.batch_stager("cpu")
    assert receive is None
    b = _batches(10, 16)[0]
    for x, y in zip(stage(b), convert.read_batch_to_torch(b)):
        assert torch.equal(x, y)

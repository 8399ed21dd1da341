"""Primitive probes on the card: scatters, gathers and sorts at the count's sizes.

    python -m genome_assembly_tpu_torch.tools.bench_prims          # on the card
    python -m genome_assembly_tpu_torch.tools.bench_prims --cpu    # on the CPU

The counterpart of the JAX package's ``tools/bench_prims.py``, the same
probes on the same sizes: scatter-add, scatter-min and gather at
``n = 16384 * 97`` (1.59 M) random indices; row sorts of ``[192, 8192]``
and ``[1536, 1024]`` and the flat sort of ``8 n`` (12.7 M) keys, the two
uint32 lanes of a key as one int64; and the lane gather at ``[256, 128]``
and ``[256, 1024]``, which launches K5 (ops/lane_gather.py,
csrc/lane_gather.cu) on the card and holds it bit for bit against its plain
version and against ``torch.gather``.  The scatters and sorts are library
calls: they measure the library.

Each probe prints one JSON line: ``phase``, ``per_iter_ms`` (median of
``--reps`` timed iterations after two warm ones; CUDA events on the card,
the host clock on the CPU), ``elems_per_s``.  A lane gather that differs
raises: a failing probe fails the run (the JAX tool logs every error and
goes on).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Callable, List

import numpy as np
import torch

from genome_assembly_tpu_torch.ops import lane_gather

N = 16384 * 97  # the JAX probe's window count (1.59 M)
UINT32_MAX = 0xFFFFFFFF


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m genome_assembly_tpu_torch.tools.bench_prims", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--reps", type=int, default=9, help="timed iterations of each probe")
    return ap


def _timer(device: torch.device, reps: int) -> Callable[[Callable[[int], object]], float]:
    """per-iteration ms of fn(i): the median of ``reps`` timed calls after
    two warm ones; on the card each call between two CUDA events."""
    def timed(fn):
        for i in range(2):
            fn(i)
        times = []
        for i in range(2, 2 + reps):
            if device.type == "cuda":
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn(i)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            else:
                t0 = time.perf_counter()
                fn(i)
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    return timed


def main(argv=None, emit: Callable[[dict], None] = lambda e: print(json.dumps(e), flush=True)
         ) -> List[dict]:
    """Run every probe; each line goes to ``emit`` (printed by default).
    Returns the lines."""
    args = parser().parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_prims was asked for a CUDA device and this machine has "
                           "none; pass --cpu to run on the CPU")
    n = N
    lines: List[dict] = []

    def out(line: dict) -> None:
        lines.append(line)
        emit(line)

    out({"phase": "env", "device": torch.cuda.get_device_name(0) if device.type == "cuda"
         else "cpu", "n": n})
    rng = np.random.default_rng(0)
    hi0 = torch.from_numpy(rng.integers(0, 1 << 30, size=n, dtype=np.int64)).to(device)
    lo0 = torch.from_numpy(rng.integers(0, 1 << 32, size=n, dtype=np.int64)).to(device)
    idx0 = torch.from_numpy(rng.integers(0, n, size=n, dtype=np.int64)).to(device)
    timed = _timer(device, args.reps)

    def probe(name, fn, denom=n):
        ms = timed(fn)
        out({"phase": name, "per_iter_ms": ms, "elems_per_s": denom / (ms * 1e-3)})

    ones = torch.ones(n, dtype=torch.int64, device=device)

    def scatter_add(i):
        ix = (idx0 + i) % n
        return torch.zeros(n, dtype=torch.int64, device=device).index_add_(0, ix, ones).sum()

    def scatter_min(i):
        ix = (idx0 + i) % n
        t = torch.full((n,), UINT32_MAX, dtype=torch.int64, device=device)
        return t.scatter_reduce_(0, ix, lo0 ^ i, reduce="amin").sum()

    def gather(i):
        return lo0[(idx0 + i) % n].sum()

    def row_sort(rows, cols):
        key = ((hi0[: rows * cols] << 32) | lo0[: rows * cols]).view(rows, cols)

        def fn(i):
            return torch.sort(key ^ ((i << 32) | i), dim=1).values.sum()
        return fn

    size = f"{n / 1e6:.2f}M"
    probe(f"scatter_add_{size}", scatter_add)
    probe(f"scatter_min_{size}", scatter_min)
    probe(f"gather_{size}", gather)
    for rows, cols in ((192, 8192), (1536, 1024)):
        probe(f"rowsort_{rows}x{cols}", row_sort(rows, cols), denom=rows * cols)
    key8 = ((hi0 << 32) | lo0).repeat(8)
    probe(f"sort_{8 * n / 1e6:.1f}M", lambda i: torch.sort(key8 ^ ((i << 32) | i)).values.sum(),
          denom=8 * n)
    del key8

    # the lane gather: K5 on the card, held to its plain version and the library
    for cols in (128, 1024):
        rows = 256
        x = hi0[: rows * cols].to(torch.int32).view(rows, cols)
        gidx = (idx0[: rows * cols] % cols).to(torch.int32).view(rows, cols)
        got = lane_gather.lane_gather(x, gidx)
        plain = lane_gather.lane_gather_plain(x, gidx)
        library = torch.gather(x, 1, gidx.long())
        if not (torch.equal(got, plain) and torch.equal(got, library)):
            raise AssertionError(
                f"lane_gather at [{rows}, {cols}]: {int((got != plain).sum())} elements differ "
                f"from the plain version, {int((got != library).sum())} from torch.gather")
        # timed without the dispatcher's range check (a read-back), as the
        # other probes time their operation alone
        if device.type == "cuda":
            from genome_assembly_tpu_torch.ops import lane_gather_cuda

            ms = timed(lambda i: lane_gather_cuda.lane_gather_cuda(x, gidx))
        else:
            ms = timed(lambda i: lane_gather.lane_gather_plain(x, gidx))
        out({"phase": f"lane_gather_c{cols}", "ok": True, "per_iter_ms": ms,
             "elems_per_s": rows * cols / (ms * 1e-3)})
    return lines


if __name__ == "__main__":
    main()
    sys.exit(0)

"""Elastic supervisor: a world that loses a process is relaunched one
process smaller, on the same checkpoint directory.

  python -m genome_assembly_tpu_torch.tools.run_elastic --procs 4 --out e.json \\
      --ckpt-dir DIR --device cpu [--die-after-batch N --die-rank R] [--rows 48]

``supervise`` launches the checkpointed count of ``run_multihost_ckpt.py``
over ``nproc`` processes and watches them.  When a rank dies (a signal, a
crash, a non-zero exit) the world has failed: the launcher stops the
survivors hung on the broken collective, and a new world of one process
fewer starts on the same directory.  The count shards are routed again onto
the smaller mesh by their owner hash (``utils/checkpoint.load_count_shards``),
so it resumes after the last committed batch.  The fault flags go to the
first world only.  The batch rows stay fixed across worlds (``rows`` must
divide by every world's size).

Writes ``{"attempts": [world sizes], "summary": rank 0's summary of the
world that completed}`` to ``out`` and returns it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from genome_assembly_tpu_torch.tools import run_multihost_ckpt


def supervise(nproc: int, out, ckpt_dir, die_after_batch=None, die_rank=None, *,
              min_procs: int = 2, device: str = "cuda", backend=None, timeout: float = 600.0,
              **dataset) -> dict:
    """Run worlds of ``nproc``, ``nproc - 1`` ... processes (down to
    ``min_procs``) until one completes.  dataset: any of
    ``run_multihost_ckpt.DATASET``'s fields.  Raises RuntimeError when no
    world completes."""
    args = run_multihost_ckpt.parse_args(["--procs", str(nproc), "--ckpt-dir", str(ckpt_dir),
                                          "--device", device, "--timeout", str(timeout)])
    args.backend = backend
    args.die_after_batch, args.die_rank = die_after_batch, die_rank
    for name, value in dataset.items():
        if name not in run_multihost_ckpt.DATASET:
            raise TypeError(f"unknown dataset field {name!r}")
        setattr(args, name, value)
    attempts, rcs, tails = [], [], [""]
    while args.procs >= min_procs:
        attempts.append(args.procs)
        rcs, tails, timed_out, summary = run_multihost_ckpt.run_world(args)
        if summary is not None:
            result = {"attempts": attempts, "summary": summary}
            pathlib.Path(out).write_text(json.dumps(result))
            return result
        # the fault flags arm the first world only; the dead rank does not
        # come back
        args.die_after_batch = args.die_rank = None
        args.procs -= 1
    raise RuntimeError(f"no world of {min_procs} or more processes completed "
                       f"(worlds {attempts}); last exit codes {rcs}: {tails[-1][-1500:]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--procs", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--die-after-batch", type=int)
    ap.add_argument("--die-rank", type=int)
    ap.add_argument("--min-procs", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=["gloo", "nccl"])
    ap.add_argument("--timeout", type=float, default=600.0)
    for name, default in run_multihost_ckpt.DATASET.items():
        ap.add_argument(f"--{name.replace('_', '-')}", type=type(default), default=default)
    a = ap.parse_args(argv)
    dataset = {name: getattr(a, name) for name in run_multihost_ckpt.DATASET}
    result = supervise(a.procs, a.out, a.ckpt_dir, a.die_after_batch, a.die_rank,
                       min_procs=a.min_procs, device=a.device, backend=a.backend,
                       timeout=a.timeout, **dataset)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

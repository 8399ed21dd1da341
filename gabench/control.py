"""The control of the comparison that decides ``correct``.

    python3 -m gabench.control --workload <config>.<traffic> --seeds N [N ...]

For each seed: make the cell's reads as a run does, put the reference in the
program's place computed one step below the configuration's guarantee of
exact counts (k-mers counted by 32-bit fingerprints, so that keys which
share one add up, as a counter of hashed keys would), and judge its unitigs
as a run judges the program's.  Prints one JSON line a seed with every
number compared beside its limit; a sound comparison finds the control not
correct on every seed.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

from gabench import generate
from gabench.reference import dbg_unitigs as reference
from gabench.run import ROOT, cell_spec

# 32-bit fingerprints of the keys in place of the keys (the multiplier is
# 2**64 / the golden ratio, as an int64)
FINGERPRINT_MULT = -7046029254386353131


def fingerprint(keys: torch.Tensor) -> torch.Tensor:
    return ((keys * FINGERPRINT_MULT) >> 32) & 0xFFFFFFFF


def control_kept(reads, k: int, cutoff: int, device) -> torch.Tensor:
    """The control's kept set: the reference's count with keys counted by
    their fingerprint, so keys that share one add up."""
    keys = reference.canonical_windows(reads, k, device)
    fps, counts = torch.unique(fingerprint(keys), sorted=True, return_counts=True)
    uniq = torch.unique(keys, sorted=True)
    return uniq[reference.member(fps[counts > cutoff], fingerprint(uniq))]


def control_spellings(reads, params: dict, device):
    """The control's unitigs, spelled by the reference from the control's
    kept set."""
    return reference.unitig_spellings(
        control_kept(reads, params["k"], params["abundance_cutoff"], device), params["k"])


def control_checks(root: pathlib.Path, workload: str, seed: int, device) -> dict:
    """Every number compared, for the control's output on one seed."""
    _, config, traffic, _ = cell_spec(pathlib.Path(root), workload)
    made = generate.for_cell(seed, config, traffic)
    params = config["pipeline"]
    expected = reference.Expected(made.reads, params, device)
    loaded = [row.tobytes().decode() for row in made.reads]
    return reference.judge(expected, loaded, control_spellings(made.reads, params, device),
                           device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("gabench.control: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        checks = control_checks(ROOT, args.workload, seed, device)
        limits = reference.LIMITS
        print(json.dumps({
            "workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t0,
            "correct": all(checks[n] <= limits[n] for n in limits),
            "checks": {n: {"value": checks[n], "limit": limits[n]} for n in limits}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

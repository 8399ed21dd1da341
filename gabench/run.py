"""Run one cell of the benchmark once and print its result line.

    python3 -m gabench.run --workload <config>.<traffic> --seed N --seconds S --trace 0|1

from the root of a checkout that holds the port (``genome_assembly_tpu_torch``).
Set-up makes the cell's reads from the seed, writes them one read a line to
a file in ``$TMPDIR``, builds ``FastAssembler`` on the card and assembles the
file once to warm up.  The window then assembles the file back to back, each
assembly ``asm.load(path)`` and ``asm.unitigs(reads)`` (what ``assemble --mode
fast`` runs), until ``--seconds`` have passed; the last assembly to start
runs to its end.  With ``--trace 1`` the window runs under a
``torch.profiler`` capture that the harness opens itself (``capture``) and
the line holds the per-layer metrics, else the end-to-end ones.  Once the
window has closed the outputs are judged against the plain reference in
``gabench/reference``.  Each step after the window (the capture's end, its
export, ``read_trace``, the readers, the breakdown, the judging) writes one
line to stderr as it ends, and the line's ``window.post_s`` holds their sum.

Everything that belongs to one cell is found by name: the workload in
``BENCHMARK.json``, its configuration in ``gabench/configs/<config>.json``,
its traffic in ``gabench/traffic/<traffic>.json``, and each metric's reader
in ``gabench/metrics/<metric>.py`` (``read(observed)`` returns the value, or
None where the cell has nothing to read).
"""

import time

# set-up is timed from here, before the imports, which are part of it
PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import List, Optional  # noqa: E402

import torch  # noqa: E402

from gabench import generate  # noqa: E402
from gabench.reference import dbg_unitigs as reference  # noqa: E402
from gabench.trace import WINDOW, Trace, read_trace  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
PROGRAM = "genome_assembly_tpu_torch"
# top-level modules that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "genome_assembly_tpu")
# the refusals of a faulty capture on a card
NO_CUPTI = ("a CUDA device is present but torch.profiler cannot record CUDA activity "
            "(no CUPTI); refusing a host-only trace")
NO_DEVICE_ACTIVITY = ("the profiler recorded no CUDA activity on a machine with a CUDA "
                      "device; refusing a host-only trace")


def _cache_dirs(root: pathlib.Path) -> None:
    """The program's build and kernel caches, at fixed places in the checkout
    (the port itself builds its CUDA libraries into its own ``build/``)."""
    cache = root / "gabench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


@dataclasses.dataclass
class Assembly:
    load_s: float
    seconds: float
    wall_s: dict


@dataclasses.dataclass
class Observed:
    """What a run saw, handed to every metric's reader."""

    config: dict
    setup_s: float
    window_s: float
    assemblies: List[Assembly]
    peak_device_bytes: int
    trace: Optional[Trace] = None

    def mean_wall(self, *phases: str) -> Optional[float]:
        """Mean seconds an assembly spent in the program's phases, or None
        where no assembly had any of them."""
        if not any(p in a.wall_s for a in self.assemblies for p in phases):
            return None
        return sum(a.wall_s.get(p, 0.0) for a in self.assemblies for p in phases) / len(
            self.assemblies)


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(root: pathlib.Path, workload: str):
    """(cell, configuration, traffic, whole spec) of a workload named in
    ``root/BENCHMARK.json``; an unknown name raises."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise ValueError(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    config = load_json(root / "gabench" / "configs" / f"{cell['config']}.json")
    traffic = load_json(root / "gabench" / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic, spec


def cell_metrics(spec: dict, workload: str, traced: bool) -> List[dict]:
    """The metric entries a run of the cell reports: per-layer when traced,
    else end-to-end; an entry without ``workloads`` holds for every cell."""
    kind = "per_layer" if traced else "end_to_end"
    return [m for m in spec[kind] if workload in m.get("workloads", [workload])]


def metric_reader(root: pathlib.Path, name: str):
    """The ``read`` function of ``gabench/metrics/<name>.py`` under root."""
    path = root / "gabench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no reader for metric {name!r} at {path}")
    module_spec = importlib.util.spec_from_file_location(f"gabench_metric_{name}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read


def check_program(root: pathlib.Path) -> None:
    """Raise unless the port imports, from the checkout at root."""
    import genome_assembly_tpu_torch

    where = pathlib.Path(genome_assembly_tpu_torch.__file__).resolve()
    if root.resolve() not in where.parents:
        raise RuntimeError(f"{PROGRAM} was imported from {where}, not from the checkout {root}")


def build_program(params: dict, device):
    """``FastAssembler`` with the configuration's ``PipelineConfig``."""
    from genome_assembly_tpu_torch.config import PipelineConfig
    from genome_assembly_tpu_torch.models.pipeline import FastAssembler

    return FastAssembler(PipelineConfig(**params), device=device)


def assemble(asm, path: str):
    """One assembly of the read file: (reads loaded, unitigs, Assembly)."""
    t0 = time.perf_counter()
    with torch.profiler.record_function("load"):
        reads = asm.load(path)
    t1 = time.perf_counter()
    unitigs, stats = asm.unitigs(reads)
    t2 = time.perf_counter()
    return reads, unitigs, Assembly(load_s=t1 - t0, seconds=t2 - t0, wall_s=dict(stats.wall_s))


def capture(on_card: bool):
    """A ``torch.profiler`` capture of the host's operator calls and, on a
    card, of its kernels, copies and sets, with the profiler's defaults.
    Refuses where a card is present and the profiler cannot record it."""
    from torch.profiler import ProfilerActivity, profile, supported_activities

    activities = [ProfilerActivity.CPU]
    if on_card:
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError(f"gabench: {NO_CUPTI}")
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def export(prof, trace_dir: str) -> None:
    """Write the capture as one Chrome trace in trace_dir, without building
    the profiler's event tree."""
    prof.export_chrome_trace(
        str(pathlib.Path(trace_dir) / f"trace_{os.getpid()}_{time.time_ns()}.json"))


def read_capture(trace_dir: str, on_card: bool) -> Trace:
    """The Trace of the one file in trace_dir; on a card, refuses a trace
    that holds no kernel, copy or set."""
    events, ranges, _ = read_trace(trace_dir)
    if on_card and not any(events.values()):
        raise RuntimeError(f"gabench: {NO_DEVICE_ACTIVITY}")
    return Trace(events, ranges)


class AfterWindow:
    """Seconds of each step after the window, each written to stderr as it
    ends, so that a run stopped there shows where its time went."""

    def __init__(self, closed: float):
        self.last = closed
        self.total = 0.0

    def step(self, name: str) -> None:
        now = time.perf_counter()
        seconds, self.last = now - self.last, now
        self.total += seconds
        print(f"gabench: after the window, {name} {seconds:.3f} s ({self.total:.3f} s in all)",
              file=sys.stderr, flush=True)


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def run_cell(root: pathlib.Path, workload: str, seed: int, seconds: float, traced: bool,
             device) -> dict:
    """Run one cell once on ``device``; returns the result line's fields
    and, under ``checks``, every number compared with its limit."""
    root = pathlib.Path(root)
    device = torch.device(device)
    cell, config, traffic, spec = cell_spec(root, workload)
    metrics = cell_metrics(spec, workload, traced)
    readers = {m["name"]: metric_reader(root, m["name"]) for m in metrics}
    on_card = device.type == "cuda"

    made = generate.for_cell(seed, config, traffic)
    fd, path = tempfile.mkstemp(prefix="gabench_reads_", suffix=".txt")
    trace_dir = tempfile.mkdtemp(prefix="gabench_trace_") if traced else None
    try:
        with os.fdopen(fd, "wb") as f:
            made.write(f)
            # on the disk before the window, so no write-back runs inside it
            f.flush()
            os.fsync(f.fileno())
        asm = build_program(config["pipeline"], device)
        _, _, warmup = assemble(asm, path)
        gc.collect()
        _reset_peak(device)

        # every assembly's reads and unitigs are kept to be judged after the window
        loads, outputs, runs = [], [], []
        prof = capture(on_card) if traced else contextlib.nullcontext()
        with prof:
            start = time.perf_counter()
            deadline = start + seconds
            with torch.profiler.record_function(WINDOW):
                while True:
                    loaded, unitigs, one = assemble(asm, path)
                    runs.append(one)
                    loads.append(loaded)
                    outputs.append(unitigs)
                    end = time.perf_counter()
                    if end >= deadline:
                        break
        after = AfterWindow(end)
        observed = Observed(config=config, setup_s=start - PROCESS_START,
                            window_s=end - start, assemblies=runs,
                            peak_device_bytes=_peak(device))
        if traced:
            after.step("capture")
            export(prof, trace_dir)
            after.step("export")
            observed.trace = read_capture(trace_dir, on_card)
            after.step("read_trace")
        values = {m["name"]: readers[m["name"]](observed) for m in metrics}
        after.step("readers")
        breakdown = ({"device_ops": observed.trace.top_device_ops(),
                      "idle_gaps": observed.trace.idle_gaps()} if traced else None)
        described = describe_device(device, cell["chips"], observed)
        after.step("breakdown")

        # judged once the window has closed and the program's state is gone
        del asm
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        after.step("free")
        judge_start = time.perf_counter()
        expected = reference.Expected(made.reads, config["pipeline"], device)
        judged = []
        for i, (loaded, out) in enumerate(zip(loads, outputs)):
            # an output equal to one judged before reads the same, but for its own load
            same = next((j for j in range(i) if outputs[j] == out), None)
            judged.append(reference.judge(expected, loaded, out, device) if same is None else
                          dict(judged[same], reads_diff=reference.reads_diff(made.reads, loaded)))
        judge_s = time.perf_counter() - judge_start
        after.step("judge")
    finally:
        os.unlink(path)
        if trace_dir:
            shutil.rmtree(trace_dir, ignore_errors=True)

    limits = reference.LIMITS
    failed = sum(any(j[name] > limits[name] for name in limits) for j in judged)
    checks = {name: {"value": max(j[name] for j in judged), "limit": limit}
              for name, limit in limits.items()}
    result = {
        "correct": failed == 0,
        "attempted": len(runs),
        "failed": failed,
        "metrics": {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                    for m in metrics if values[m["name"]] is not None},
        "device": described,
    }
    if traced:
        result["breakdown"] = breakdown
    result["window"] = {"assembly_s": [a.seconds for a in runs], "warmup_s": warmup.seconds,
                        "load_s": [a.load_s for a in runs],
                        "phase_s": [a.wall_s for a in runs],
                        "reads": made.n_reads, "judge_s": judge_s, "post_s": after.total}
    result["checks"] = checks
    return result


def describe_device(device, chips: int, observed: Observed) -> dict:
    out = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": chips,
           "memory_peak_bytes": observed.peak_device_bytes}
    if observed.trace is not None:
        out["busy_s"] = observed.trace.busy_s()
        out["window_s"] = observed.trace.window_s()
    if device.type == "cuda":
        out["power_limit"] = power_limit()
    out["host"] = {"cpus": os.cpu_count(), "affinity": len(os.sched_getaffinity(0)),
                   "torch_threads": torch.get_num_threads()}
    return out


def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        done = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "--id=0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return done.stdout.strip() or None


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    _cache_dirs(ROOT)
    cell, _, _, _ = cell_spec(ROOT, args.workload)
    check_program(ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"gabench: the cell needs {cell['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"gabench: the run's process loaded {found}", file=sys.stderr)
        return 2
    for name, check in result["checks"].items():
        print(f"{name} {check['value']} limit {check['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

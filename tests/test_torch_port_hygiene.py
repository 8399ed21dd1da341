"""The port stands alone: it imports torch and numpy, never jax and nothing
of the JAX package; it does not build or import its CUDA binding at import;
its default device is the card and it does not fall back to the CPU.

Every check runs in a SUBPROCESS: the conftest of this test run imports jax,
so ``sys.modules`` here says nothing about what the port pulls in.
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent

_PRELUDE = """
import importlib, pkgutil, sys
import genome_assembly_tpu_torch as pkg

def jax_side():
    return sorted(
        m for m in sys.modules
        if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
        or m == "genome_assembly_tpu" or m.startswith("genome_assembly_tpu."))

def all_modules():
    return [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
            if not m.name.endswith("__main__")]
"""


def _run(body: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-c", _PRELUDE + body],
        cwd=str(REPO_ROOT), env=env, capture_output=True, text=True, timeout=300,
    )


def test_importing_every_module_pulls_in_no_jax():
    r = _run("""
names = all_modules()
assert len(names) >= 19, names
assert pkg.__name__ + ".ops.bitonic_sort" in names and pkg.__name__ + ".ops.bitonic_cuda" in names
assert pkg.__name__ + ".ops.mergepath_sort" in names and pkg.__name__ + ".ops.mergepath_cuda" in names
for mod in ("mesh", "distributed", "ragged", "shard_count", "part_dbg", "shard_dbg"):
    assert f"{pkg.__name__}.parallel.{mod}" in names, mod
assert pkg.__name__ + ".tools.run_multihost" in names
for mod in ("entry", "utils.metrics", "utils.profiling", "utils.checkpoint", "utils.plots"):
    assert f"{pkg.__name__}.{mod}" in names, mod
for n in names:
    importlib.import_module(n)
assert jax_side() == [], jax_side()
print("OK", len(names))
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("OK")


def test_cuda_binding_is_neither_imported_nor_built_at_package_import():
    r = _run("""
import genome_assembly_tpu_torch.models.pipeline
import genome_assembly_tpu_torch.cli
import genome_assembly_tpu_torch.convert
assert "genome_assembly_tpu_torch.ops.minimizer_cuda" not in sys.modules
assert "genome_assembly_tpu_torch.csrc.build" not in sys.modules
# importing the binding module still builds and loads nothing
from genome_assembly_tpu_torch.ops import minimizer_cuda
from genome_assembly_tpu_torch.csrc import build
assert minimizer_cuda._lib is None and build._loaded == {}
assert minimizer_cuda.launch_count == 0
print("OK")
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "OK"


def test_bitonic_binding_is_neither_imported_nor_built_at_package_import():
    r = _run("""
import genome_assembly_tpu_torch.models.pipeline
import genome_assembly_tpu_torch.ops.count
import genome_assembly_tpu_torch.ops.bitonic_sort
assert "genome_assembly_tpu_torch.ops.bitonic_cuda" not in sys.modules
assert "genome_assembly_tpu_torch.csrc.build" not in sys.modules
# a CPU sort goes through the plain passes and still imports no binding
import torch
from genome_assembly_tpu_torch.ops import bitonic_sort
key = torch.arange(99, 0, -1)
assert torch.equal(bitonic_sort.sort_keys_hybrid(key, lib_chunk=8, chunk=4), key.flip(0))
assert "genome_assembly_tpu_torch.ops.bitonic_cuda" not in sys.modules
# importing the binding module builds and loads nothing
from genome_assembly_tpu_torch.ops import bitonic_cuda
from genome_assembly_tpu_torch.csrc import build
assert bitonic_cuda._lib is None and build._loaded == {}
assert set(bitonic_cuda.launch_count.values()) == {0}
assert sorted(bitonic_cuda.launch_count) == [
    "big_ce", "chunk_sort", "finish", "sort_rows"]
print("OK")
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "OK"


def test_mergepath_binding_is_neither_imported_nor_built_at_package_import():
    r = _run("""
import genome_assembly_tpu_torch.models.pipeline
import genome_assembly_tpu_torch.ops.mergepath_sort
assert "genome_assembly_tpu_torch.ops.mergepath_cuda" not in sys.modules
assert "genome_assembly_tpu_torch.csrc.build" not in sys.modules
# a CPU sort goes through the plain passes and still imports no binding
import torch
from genome_assembly_tpu_torch.ops import mergepath_sort
key = torch.arange(99, 0, -1)
assert torch.equal(mergepath_sort.sort_keys_mergepath(key, tile=4, base_run=2, chunk=8), key.flip(0))
assert torch.equal(mergepath_sort.sort_keys_mergepath(key, tile=4, base_run=1, chunk=8), key.flip(0))
# so does the split search of a CPU tensor: the dispatcher takes the plain form
state = torch.arange(64).view(4, 16).flip(0).reshape(-1)
for ours, plain in zip(mergepath_sort.merge_splits(state, 16, 4),
                       mergepath_sort.merge_splits_plain(state, 16, 4)):
    assert torch.equal(ours, plain)
assert "genome_assembly_tpu_torch.ops.mergepath_cuda" not in sys.modules
assert "genome_assembly_tpu_torch.ops.bitonic_cuda" not in sys.modules
# importing the binding module builds and loads nothing
from genome_assembly_tpu_torch.ops import mergepath_cuda
from genome_assembly_tpu_torch.csrc import build
assert mergepath_cuda._lib is None and build._loaded == {}
assert mergepath_cuda.launch_count == {"local_merge": 0, "merge_pass": 0, "merge_splits": 0}
print("OK")
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "OK"


@pytest.mark.parametrize("call", [
    "local_merge_cuda(torch.zeros(64, dtype=torch.int64), [4, 8], chunk=8)",
    "merge_pass_cuda(torch.zeros(64, dtype=torch.int64), torch.zeros(8, dtype=torch.int64), "
    "torch.zeros(8, dtype=torch.int64), run=8, tile=8)",
    "merge_splits_cuda(torch.zeros(64, dtype=torch.int64), 8, 8)",
])
def test_mergepath_cuda_wrappers_refuse_cpu_tensors(call):
    r = _run(f"""
import torch
from genome_assembly_tpu_torch.ops import mergepath_cuda
try:
    mergepath_cuda.{call}
except ValueError as e:
    print("RAISED", e)
assert set(mergepath_cuda.launch_count.values()) == {{0}} and mergepath_cuda._lib is None
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("RAISED") and "CUDA" in r.stdout


def test_every_cuda_source_has_a_binding_and_no_library_sort():
    """Each source of csrc/ is loaded by one binding module, and no kernel
    source calls a library's sort or merge."""
    csrc = REPO_ROOT / "genome_assembly_tpu_torch" / "csrc"
    ops = REPO_ROOT / "genome_assembly_tpu_torch" / "ops"
    bindings = "".join(p.read_text() for p in ops.glob("*_cuda.py"))
    sources = sorted(csrc.glob("*.cu"))
    assert [s.stem for s in sources] == ["bitonic", "fast_scan", "mergepath"]
    for source in sources:
        assert f'build.load("{source.stem}")' in bindings
        text = source.read_text()
        assert "__global__" in text
        assert not re.search(r"\b(cub|thrust)::|#include\s*<(cub|thrust)/", text)
        # every kernel of the source is launched by a C function the binding names
        kernels = re.findall(r"^(\w+_kernel)\(", text, flags=re.M)
        assert kernels
        for kernel in kernels:
            launcher = kernel.replace("_kernel", "_launch")
            assert re.search(rf'extern "C" int {launcher}\(', text), launcher
            assert f"lib.{launcher}" in bindings or f".{launcher}(" in bindings, launcher
    merge = (csrc / "mergepath.cu").read_text()
    assert re.findall(r"^(\w+_kernel)\(", merge, flags=re.M) == [
        "local_merge_kernel", "merge_pass_kernel", "merge_splits_kernel"]
    bitonic = (csrc / "bitonic.cu").read_text()
    assert re.findall(r"^(\w+_kernel)\(", bitonic, flags=re.M) == [
        "sort_rows_kernel", "chunk_sort_kernel", "finish_kernel", "big_ce_kernel"]
    scan = (csrc / "fast_scan.cu").read_text()
    assert re.findall(r"^(\w+_kernel)\(", scan, flags=re.M) == ["fast_scan_kernel"]
    # the scan kernel writes `valid` itself; finish takes keys a thread, not threads
    assert "valid_out" in scan.split('extern "C" int fast_scan_launch(', 1)[1].split(")", 1)[0]
    finish = bitonic.split('extern "C" int finish_launch(', 1)[1].split(")", 1)[0]
    assert "per_thread" in finish and "threads" not in finish.replace("per_thread", "")
    assert "SHARED_THREADS" not in (ops / "bitonic_cuda.py").read_text()
    # the three block merge sorts are one device routine, from the header
    for text, kernels in ((bitonic, ("sort_rows", "chunk_sort")), (merge, ("local_merge",))):
        for kernel in kernels:
            body = text.split(f"\n{kernel}_kernel(", 1)[1].split("\n}\n", 1)[0]
            assert "sort_blocks<" in body, kernel


def test_every_cuda_header_is_included_and_holds_no_interface_and_no_library_sort():
    csrc = REPO_ROOT / "genome_assembly_tpu_torch" / "csrc"
    headers = sorted(csrc.glob("*.cuh"))
    assert [h.name for h in headers] == ["block_sort.cuh"]
    sources = {s.name: s.read_text() for s in csrc.glob("*.cu")}
    for header in headers:
        users = [name for name, text in sources.items() if f'#include "{header.name}"' in text]
        assert sorted(users) == ["bitonic.cu", "mergepath.cu"]
        text = header.read_text()
        assert 'extern "C"' not in text and "__global__" not in text
        assert not re.search(r"\b(cub|thrust)::|#include\s*<(cub|thrust)/", text)
        assert "#pragma once" in text


def test_library_name_follows_the_source_the_headers_and_nothing_else(tmp_path):
    """An edited header must leave no stale library behind: the name of every
    source's library changes with any ``*.cuh`` beside it (no nvcc needed)."""
    import shutil

    from genome_assembly_tpu_torch.csrc import build

    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, copy, ignore=shutil.ignore_patterns("__pycache__"))
    names = {s.stem: build._library_path(s).name for s in sorted(copy.glob("*.cu"))}
    assert names == {s.stem: build._library_path(s).name
                     for s in sorted(build.CSRC_DIR.glob("*.cu"))}
    assert all(build._library_path(copy / f"{stem}.cu").parent == build.BUILD_DIR
               for stem in names)
    (copy / "build.py").write_text("# not a source\n")
    assert names == {s.stem: build._library_path(s).name for s in copy.glob("*.cu")}
    header = copy / "block_sort.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after_header = {s.stem: build._library_path(s).name for s in copy.glob("*.cu")}
    assert all(after_header[stem] != names[stem] for stem in names)
    source = copy / "bitonic.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    after_source = {s.stem: build._library_path(s).name for s in copy.glob("*.cu")}
    assert after_source["bitonic"] != after_header["bitonic"]
    assert after_source["mergepath"] == after_header["mergepath"]
    (copy / "other.cuh").write_text("// a new header\n")
    assert all(build._library_path(s).name != after_source[s.stem] for s in copy.glob("*.cu"))


@pytest.mark.parametrize("call", [
    "sort_rows_cuda(torch.zeros((4, 8), dtype=torch.int64))",
    "chunk_sort_cuda(torch.zeros(64, dtype=torch.int64), [2, 4, 8], chunk=8)",
    "chunk_sort_cuda(torch.zeros(64, dtype=torch.int64), [16], chunk=8)",
    "big_ce_cuda(torch.zeros(64, dtype=torch.int64), 8, 16)",
    "finish_cuda(torch.zeros(64, dtype=torch.int64), 16, chunk=8)",
])
def test_bitonic_cuda_wrappers_refuse_cpu_tensors(call):
    r = _run(f"""
import torch
from genome_assembly_tpu_torch.ops import bitonic_cuda
try:
    bitonic_cuda.{call}
except ValueError as e:
    print("RAISED", e)
assert set(bitonic_cuda.launch_count.values()) == {{0}} and bitonic_cuda._lib is None
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("RAISED") and "CUDA" in r.stdout


def test_hybrid_sort_raises_without_a_card_rather_than_running_on_the_cpu():
    r = _run("""
import torch
from genome_assembly_tpu_torch.config import PipelineConfig
from genome_assembly_tpu_torch.models.pipeline import FastAssembler
cfg = PipelineConfig(k=11, m=5, parity=False, max_read_len=64, batch_reads=64, hybrid_sort=True)
try:
    FastAssembler(cfg).unitigs(["ACGTTGCATGCCGATAGCTAGCTAGGATCGATCGA"] * 4)
except RuntimeError as e:
    print("RAISED", e)
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("RAISED") and "CUDA" in r.stdout


def test_source_files_name_no_jax_import():
    offenders = []
    files = list((REPO_ROOT / "genome_assembly_tpu_torch").rglob("*.py"))
    files.append(REPO_ROOT / "chip_smoke.py")
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|genome_assembly_tpu)(\.|\s|$)")
    for path in files:
        for line in path.read_text().splitlines():
            if pattern.match(line):
                offenders.append(f"{path.name}: {line.strip()}")
    assert offenders == []


@pytest.mark.parametrize(
    "call",
    ["FastAssembler(cfg).unitigs(reads)", "FastAssembler(cfg, device='cuda').unitigs(reads)"],
)
def test_default_device_is_the_card_and_raises_without_one(call):
    r = _run(f"""
import torch
assert not torch.cuda.is_available()
from genome_assembly_tpu_torch.config import PipelineConfig
from genome_assembly_tpu_torch.models.pipeline import FastAssembler
cfg = PipelineConfig(k=11, m=5, parity=False, max_read_len=64, batch_reads=64)
reads = ["ACGTTGCATGCCGATAGCTAGCTAGGATCGATCGA"] * 4
try:
    out = {call}
except RuntimeError as e:
    print("RAISED", e)
else:
    print("RAN", out)
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("RAISED"), r.stdout
    assert "CUDA" in r.stdout


@pytest.mark.parametrize("call", [
    "entry.entry()",
    "stream.feed_read_batches(batches)",
    "cli.main(['count', 'tests/golden/input.txt', '--k', '6', '--m', '3'])",
    "cli.main(['assemble', 'tests/golden/input.txt', '--k', '6', '--m', '3', '--metrics', "
    "os.devnull])",
])
def test_new_entry_points_default_to_the_card_and_raise_without_one(call):
    r = _run(f"""
import os
import torch
assert not torch.cuda.is_available()
from genome_assembly_tpu_torch import cli, entry
from genome_assembly_tpu_torch.io import reads, stream
batches = reads.batch_reads(["ACGTTGCATGCCGATAGCTAGCTAGGATCGATCGA"] * 4, 64, 2)
try:
    out = {call}
except RuntimeError as e:
    print("RAISED", e)
else:
    print("RAN", out)
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("RAISED"), r.stdout
    assert "CUDA" in r.stdout


def test_cuda_wrapper_refuses_cpu_tensors():
    r = _run("""
import torch
from genome_assembly_tpu_torch.ops import minimizer_cuda
try:
    minimizer_cuda.fast_scan_cuda(
        torch.zeros((2, 40), dtype=torch.uint8), torch.zeros(2, dtype=torch.int32), k=21, m=7)
except ValueError as e:
    print("RAISED", e)
assert minimizer_cuda.launch_count == 0 and minimizer_cuda._lib is None
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("RAISED")


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, str(REPO_ROOT / "chip_smoke.py")],
        cwd=str(REPO_ROOT), env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_cli_drives_the_fast_path_on_the_cpu(tmp_path):
    reads = tmp_path / "r.txt"
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), CUDA_VISIBLE_DEVICES="")
    gen = subprocess.run(
        [sys.executable, "-m", "genome_assembly_tpu_torch", "generate",
         "--genome-len", "1200", "--coverage", "8", "--read-len", "64", "--seed", "5",
         "--with-reverse", "--out", str(reads)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300,
    )
    assert gen.returncode == 0, gen.stderr
    base = [sys.executable, "-m", "genome_assembly_tpu_torch", "assemble", str(reads),
            "--mode", "fast", "--k", "21", "--m", "7"]
    on_cpu = subprocess.run(base + ["--cpu"], cwd=str(tmp_path), env=env,
                            capture_output=True, text=True, timeout=300)
    assert on_cpu.returncode == 0, on_cpu.stderr
    unitigs = on_cpu.stdout.split()
    assert unitigs and all(set(u) <= set("ACGT") and len(u) >= 21 for u in unitigs)
    cov = subprocess.run(base + ["--cpu", "--coverage"], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=300)
    assert cov.returncode == 0, cov.stderr
    rows = [line.split("\t") for line in cov.stdout.splitlines()]
    assert [r[0] for r in rows] == unitigs
    assert all(int(r[1]) == len(r[0]) - 21 + 1 for r in rows)
    # --hybrid-sort changes the sort's route, not the output
    hybrid = subprocess.run(base + ["--cpu", "--hybrid-sort"], cwd=str(tmp_path), env=env,
                            capture_output=True, text=True, timeout=300)
    assert hybrid.returncode == 0, hybrid.stderr
    assert hybrid.stdout == on_cpu.stdout
    # without --cpu on a machine without a card: refuses, prints no unitigs
    on_card = subprocess.run(base, cwd=str(tmp_path), env=env,
                             capture_output=True, text=True, timeout=300)
    assert on_card.returncode != 0 and on_card.stdout == ""


_FAKE_NVCC = """#!/bin/sh
# stands in for nvcc: writes the -o file, prints a ptxas-like line, counts its calls
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo "ptxas info    : Used 12 registers, 0 bytes smem" 
printf 'library' > "$out"
echo call >> "$(dirname "$0")/calls"
"""


def test_build_reuses_a_library_and_still_fills_the_build_log(tmp_path, monkeypatch):
    """A second build_all (a second chip_smoke.py run in one checkout) runs
    no compiler and still gives every source what nvcc printed when it built
    the library, read back from the log kept beside it."""
    from genome_assembly_tpu_torch.csrc import build

    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "build_log", {})
    stems = sorted(s.stem for s in build.CSRC_DIR.glob("*.cu"))

    first = build.build_all()
    calls = (nvcc.parent / "calls").read_text().split()
    assert sorted(first) == stems and len(calls) == len(stems)
    assert all(p.exists() and p.with_suffix(".log").exists() for p in first.values())
    assert all("Used 12 registers" in build.build_log[stem] for stem in stems)

    build.build_log.clear()
    second = build.build_all(verbose=True)
    assert second == first
    assert (nvcc.parent / "calls").read_text().split() == calls  # nothing compiled again
    assert sorted(build.build_log) == stems
    assert all("Used 12 registers" in build.build_log[stem] for stem in stems)


def test_chip_smoke_alone_names_the_missing_package(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the repo
    the script fails, and says on stderr what it could not import."""
    import shutil

    shutil.copy(REPO_ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(tmp_path), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""
    assert "genome_assembly_tpu_torch" in r.stderr and str(tmp_path) in r.stderr


def test_a_mesh_of_cards_raises_without_one():
    """``make_mesh()`` takes the visible CUDA devices: without one it raises
    (it never builds a CPU mesh unasked), and so does a mesh, a process
    group or an assembler asked for a card."""
    r = _run("""
import torch
assert not torch.cuda.is_available()
from genome_assembly_tpu_torch.parallel import distributed, mesh
for call in (lambda: mesh.make_mesh(), lambda: mesh.make_mesh(4),
             lambda: mesh.make_mesh(4, devices=["cuda"]),
             lambda: mesh.make_mesh(2, devices="cuda:0"),
             lambda: distributed.init_multi_host("127.0.0.1:1", 2, 0, device="cuda")):
    try:
        call()
    except RuntimeError as e:
        assert "CUDA" in str(e), e
    else:
        raise AssertionError("no error")
try:
    distributed.global_mesh("cpu")
except RuntimeError as e:
    assert "init_multi_host" in str(e)
else:
    raise AssertionError("no error")
assert mesh.make_mesh(4, devices=["cpu"]).n_shards == 4
print("OK")
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "OK"


NEW_MULTI_DEVICE_MODULES = ("parallel/two_level.py", "parallel/halo.py",
                            "tools/run_multihost_ckpt.py", "tools/run_elastic.py")


def test_second_multi_device_modules_import_no_jax():
    """The two-level router, the halo, the checkpointed runner and the
    elastic supervisor name no JAX import, and importing them (in a fresh
    process) pulls in nothing of JAX or the JAX package."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|genome_assembly_tpu)(\.|\s|$)")
    for rel in NEW_MULTI_DEVICE_MODULES:
        path = REPO_ROOT / "genome_assembly_tpu_torch" / rel
        assert [line for line in path.read_text().splitlines() if pattern.match(line)] == [], rel
    mods = [f"genome_assembly_tpu_torch.{rel[:-3].replace('/', '.')}"
            for rel in NEW_MULTI_DEVICE_MODULES]
    r = _run(f"""
names = all_modules()
for n in {mods!r}:
    assert n in names, n
    importlib.import_module(n)
assert jax_side() == [], jax_side()
print("OK")
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "OK"


@pytest.mark.parametrize("call", [
    "two_level.two_level_mesh(2)",
    "two_level.two_level_mesh3(2, 2, 2)",
])
def test_two_level_meshes_default_to_the_card(call):
    r = _run(f"""
import os
import torch
assert not torch.cuda.is_available()
from genome_assembly_tpu_torch.parallel import two_level
try:
    out = {call}
except RuntimeError as e:
    print("RAISED", e)
else:
    print("RAN", out)
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("RAISED"), r.stdout

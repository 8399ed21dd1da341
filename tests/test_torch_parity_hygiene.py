"""Parity mode stands alone too: its subpackages (``parity/``, ``native/``,
``utils/``) import no jax and nothing of the JAX package, build nothing at
import, raise without a card unless asked for the CPU, and build the C++
replay engine only into the port's own build directory.

Checks that import the package run in a SUBPROCESS: the conftest of this
test run imports jax, so ``sys.modules`` here says nothing about what the
port pulls in.
"""

import functools
import os
import pathlib
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


def test_parity_subpackages_are_walked_and_pull_in_no_jax():
    r = _run("""
names = all_modules()
for sub in ("parity.model", "parity.table", "parity.replay", "parity.nonacgt",
            "native.build", "native.replay_native", "utils.plots"):
    assert pkg.__name__ + "." + sub in names, sub
for n in names:
    importlib.import_module(n)
assert jax_side() == [], jax_side()
from genome_assembly_tpu_torch.native import replay_native
assert replay_native._lib is None  # importing builds and loads nothing
print("OK")
""")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "OK"


_CALLS = ["ParityAssembler(cfg)", "ParityAssembler(cfg, device='cuda')", "ParityAssembler()"]


@functools.lru_cache(maxsize=None)
def _default_device_outcomes() -> tuple:
    """One subprocess tries every call; one output line a call."""
    r = _run("""
import torch
assert not torch.cuda.is_available()
from genome_assembly_tpu_torch.config import PipelineConfig
from genome_assembly_tpu_torch.models.pipeline import ParityAssembler
cfg = PipelineConfig(k=6, m=3, max_read_len=32, batch_reads=64)
for call in %r:
    try:
        out = eval(call).assemble(["CAGCCGCTGGGTCCG"] * 4)
    except RuntimeError as e:
        print("RAISED", e)
    else:
        print("RAN", out)
""" % (_CALLS,))
    assert r.returncode == 0, r.stderr
    return tuple(r.stdout.splitlines())


@pytest.mark.parametrize("call", _CALLS)
def test_parity_default_device_is_the_card_and_raises_without_one(call):
    outcomes = _default_device_outcomes()
    assert len(outcomes) == len(_CALLS), outcomes
    line = outcomes[_CALLS.index(call)]
    assert line.startswith("RAISED"), line
    assert "CUDA" in line


def test_native_engine_builds_only_into_the_port_build_dir(tmp_path, monkeypatch):
    """g++ writes into the build directory of the port (git-ignored) and
    reads the port's own sources; a second call reuses the library."""
    from genome_assembly_tpu_torch.native import build

    assert build.BUILD_DIR == REPO_ROOT / "genome_assembly_tpu_torch" / "build"
    assert "genome_assembly_tpu_torch/build/" in (REPO_ROOT / ".gitignore").read_text().split()
    commands = []
    real_run = subprocess.run

    def recording_run(cmd, *args, **kwargs):
        commands.append(list(cmd))
        return real_run(cmd, *args, **kwargs)

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build.subprocess, "run", recording_run)
    lib = build.build()
    assert lib.parent == tmp_path / "build" and lib.exists()
    assert lib.with_suffix(".log").exists()
    assert sorted(p.name for p in lib.parent.iterdir()) == sorted([lib.name, lib.name[:-3] + ".log"])
    assert build.build() == lib and len(commands) == 1
    cmd = commands[0]
    out = pathlib.Path(cmd[cmd.index("-o") + 1])
    assert out.parent == tmp_path / "build"
    sources = [pathlib.Path(a) for a in cmd if a.endswith(".cpp")]
    assert sources == [build.NATIVE_DIR / "replay_engine.cpp"]
    assert build.NATIVE_DIR == REPO_ROOT / "genome_assembly_tpu_torch" / "native"

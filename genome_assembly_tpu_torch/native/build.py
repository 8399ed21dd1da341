"""Build the C++ parity replay engine with g++, at first use.

Outputs go to ``genome_assembly_tpu_torch/build/`` (not tracked by git),
named by the hash of the sources and of the compiler's flags: an edited
source or flag gives a new name, an unchanged one is reused.  What g++
printed is kept beside each output, under its name with the suffix
``.log``.  A failed build raises; nothing is written anywhere else.

  python -m genome_assembly_tpu_torch.native.build   # prints the library path
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Sequence

NATIVE_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "build"

LIBRARY_SOURCES = ("replay_engine.cpp",)
LIBRARY_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")

SELFTEST_SOURCES = ("replay_engine.cpp", "selftest_main.cpp")
SELFTEST_FLAGS = (
    "-O1", "-g", "-std=c++17",
    "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
)


def output_path(stem: str, sources: Sequence[str], flags: Sequence[str],
                suffix: str = "") -> pathlib.Path:
    """``BUILD_DIR/<stem>-<hash><suffix>``, the hash over the sources'
    names and bytes and the flags."""
    digest = hashlib.sha1()
    for name in sources:
        digest.update(name.encode() + (NATIVE_DIR / name).read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:12]}{suffix}"


def _compile(target: pathlib.Path, sources: Sequence[str],
             flags: Sequence[str]) -> pathlib.Path:
    if target.exists():
        return target
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH; the parity replay engine cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # concurrent builds each write their own file and rename it into place
    tmp = target.with_name(f"{target.name}.tmp{os.getpid()}")
    cmd = [cxx, *flags, "-o", str(tmp), *(str(NATIVE_DIR / s) for s in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = target.with_suffix(".log")
    log.write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ exited {proc.returncode} building {target.name}:\n{proc.stderr}"
        )
    os.replace(tmp, target)
    return target


def build() -> pathlib.Path:
    """The shared library of the replay engine, built if missing."""
    target = output_path("libgassembly", LIBRARY_SOURCES, LIBRARY_FLAGS, ".so")
    return _compile(target, LIBRARY_SOURCES, LIBRARY_FLAGS)


def build_sanitizer_selftest() -> pathlib.Path:
    """ASan + UBSan build of the replay engine with a synthetic driver
    (``selftest_main.cpp``), built if missing; it prints ``ok ...`` and
    exits 0 when the replay ran clean."""
    target = output_path("replay_selftest_asan", SELFTEST_SOURCES, SELFTEST_FLAGS)
    return _compile(target, SELFTEST_SOURCES, SELFTEST_FLAGS)


if __name__ == "__main__":
    print(build())

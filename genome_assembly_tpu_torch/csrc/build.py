"""Build the CUDA sources of this directory into shared libraries.

Every ``*.cu`` here has a plain C interface (no PyTorch headers), so one
``nvcc`` call per source takes seconds; all sources are compiled at the
same time.  Libraries go to ``genome_assembly_tpu_torch/build/`` (not
tracked by git), named by the hash of their source and of every header
(``*.cuh``) of this directory, so an edited source or header is rebuilt and
an unchanged one is reused.  They are loaded with ctypes.  What nvcc printed
(ptxas's registers, shared memory and spills: every build asks for them) is
kept beside each library as ``lib<stem>-<hash>.log`` and read back into
``build_log`` when the library is reused.

Nothing here runs at import: the first kernel launch calls ``load``.
A failed build raises; there is no other route to the kernel's function.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict

CSRC_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = CSRC_DIR.parent / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_loaded: Dict[str, ctypes.CDLL] = {}

# {source stem: what nvcc printed when it built the library in use}
build_log: Dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, PATH, or /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA kernels of genome_assembly_tpu_torch cannot be built"
    )


def _library_path(source: pathlib.Path) -> pathlib.Path:
    """Where the library of ``source`` goes: named by the hash of the source,
    of every header beside it (any source may include any of them) and of the
    compiler's flags."""
    digest = hashlib.sha1(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:12]}.so"


def _log_path(library: pathlib.Path) -> pathlib.Path:
    return library.with_suffix(".log")


def build_all(verbose: bool = False) -> Dict[str, pathlib.Path]:
    """Compile every source that has no up-to-date library; one nvcc per
    source, all started together.  Fills ``build_log`` for every source,
    built now or before; ``verbose`` prints what a build now printed.
    Returns {source stem: library path}."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    targets = {s.stem: _library_path(s) for s in sources}
    todo = [s for s in sources if not targets[s.stem].exists()]
    if todo:
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for s in todo:
            tmp = targets[s.stem].with_suffix(f".tmp{os.getpid()}.so")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(s)]
            procs.append(
                (s, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ))
            )
        failures = []
        for s, tmp, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                failures.append(f"{s.name}: nvcc exited {p.returncode}\n{out}")
                continue
            if verbose and out:
                print(out, flush=True)
            log = _log_path(targets[s.stem])
            log_tmp = log.with_suffix(f".tmp{os.getpid()}.log")
            log_tmp.write_text(out)
            os.replace(log_tmp, log)
            os.replace(tmp, targets[s.stem])
        if failures:
            raise RuntimeError("CUDA build failed:\n" + "\n".join(failures))
    for stem, library in targets.items():
        log = _log_path(library)
        build_log[stem] = log.read_text() if log.exists() else ""
    return targets


def load(name: str) -> ctypes.CDLL:
    """The library built from ``<name>.cu``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        targets = build_all()
        if name not in targets:
            raise KeyError(f"no CUDA source {name}.cu in {CSRC_DIR}")
        lib = ctypes.CDLL(str(targets[name]))
        _loaded[name] = lib
    return lib

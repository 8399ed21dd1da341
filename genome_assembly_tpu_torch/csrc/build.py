"""Build the CUDA sources of this directory into torch operator libraries.

Every ``<stem>.cu`` here has a torch host file beside it, ``<stem>_op.cpp``,
which registers the operators that launch its kernels (a
``TORCH_LIBRARY_FRAGMENT`` of the namespace ``ga_torch`` each).  One nvcc
call builds both into one library: the ``.cu`` with its plain C launchers,
the ``.cpp`` against torch's headers with torch's C++ ABI, linked against
torch's libraries and the shared CUDA runtime torch uses.  All sources are
compiled at the same time.  Libraries go to ``genome_assembly_tpu_torch/build/``
(not tracked by git), named by the hash of the source, of its host file, of
every header (``*.cuh``) of this directory, of the flags and of torch's and
CUDA's versions, so an edited file or a torch upgrade is rebuilt and an
unchanged one is reused.  What nvcc printed (ptxas's registers, shared
memory and spills: every build asks for them) is kept beside each library as
``lib<stem>-<hash>.log`` and read back into ``build_log`` when the library
is reused.

Nothing here runs at import: the first kernel launch calls
``load_operators``, which calls ``torch.ops.load_library`` once a process.
A source without its host file, or a failed build, raises; there is no other
route to a kernel.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, List

import torch

CSRC_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = CSRC_DIR.parent / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
# what a library links besides its inputs
OPERATOR_LIBS = ["-lc10", "-lc10_cuda", "-ltorch", "-ltorch_cpu", "-ltorch_cuda", "-lcudart"]

# {source stem: operator library loaded into torch.ops}
_operators: Dict[str, pathlib.Path] = {}

# {source stem: what nvcc printed when it built the library in use}
build_log: Dict[str, str] = {}
# {source stem: seconds from the start of this process's build until its nvcc
# ended (all start together); only the sources this process built}
build_seconds: Dict[str, float] = {}


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


def operator_source(source: pathlib.Path) -> pathlib.Path:
    """The torch host file of ``source``, ``<stem>_op.cpp`` beside it; raises
    where there is none."""
    host = source.with_name(f"{source.stem}_op.cpp")
    if not host.exists():
        raise FileNotFoundError(f"{source.name} has no torch host file {host.name} beside it")
    return host


def operator_flags(nvcc: str) -> List[str]:
    """What a library adds to ``NVCC_FLAGS`` before its inputs:
    torch's C++ ABI, torch's headers and CUDA's."""
    from torch.utils import cpp_extension

    cuda_include = pathlib.Path(nvcc).resolve().parent.parent / "include"
    return [f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
            *(f"-I{d}" for d in cpp_extension.include_paths()), f"-I{cuda_include}"]


def operator_link_flags(nvcc: str) -> List[str]:
    """What a library links after its inputs: torch's libraries,
    found at run time through an rpath, and the shared CUDA runtime torch
    uses."""
    from torch.utils import cpp_extension

    cuda_lib = pathlib.Path(nvcc).resolve().parent.parent / "lib64"
    dirs = [*cpp_extension.library_paths(), str(cuda_lib)]
    rpaths = [arg for d in dirs for arg in ("-Xlinker", f"-rpath,{d}")]
    return ["-cudart", "shared", *(f"-L{d}" for d in dirs), *rpaths, *OPERATOR_LIBS]


def _library_path(source: pathlib.Path) -> pathlib.Path:
    """Where the library of ``source`` goes: named by the hash of the source,
    of its host file, of every header beside it (any source may include any
    of them), of the compiler's flags and of torch's version, CUDA version
    and C++ ABI."""
    host = operator_source(source)
    digest = hashlib.sha1(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest.update(host.read_bytes())
    digest.update(f"{torch.__version__} {torch.version.cuda} "
                  f"{torch._C._GLIBCXX_USE_CXX11_ABI} {' '.join(OPERATOR_LIBS)}".encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:12]}.so"


def nvcc_command(nvcc: str, source: pathlib.Path, output: pathlib.Path) -> List[str]:
    """The one nvcc call that builds ``source`` and its torch host file into
    ``output``."""
    return [nvcc, *NVCC_FLAGS, *operator_flags(nvcc), "-Xptxas", "-v", "-o", str(output),
            str(source), str(operator_source(source)), *operator_link_flags(nvcc)]


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
        t0 = time.perf_counter()
        for s in todo:
            tmp = targets[s.stem].with_suffix(f".tmp{os.getpid()}.so")
            cmd = nvcc_command(nvcc, s, tmp)
            procs.append(
                (s, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ))
            )
        failures = []
        for s, tmp, p in procs:
            out, _ = p.communicate()
            build_seconds[s.stem] = time.perf_counter() - t0
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


def load_operators(name: str) -> pathlib.Path:
    """Load the operator library built from ``<name>.cu`` and
    ``<name>_op.cpp`` into ``torch.ops``, building it first if needed; once
    a process (a second load would register its operators again)."""
    path = _operators.get(name)
    if path is None:
        if not (CSRC_DIR / f"{name}.cu").exists():
            raise KeyError(f"no CUDA source {name}.cu in {CSRC_DIR}")
        path = build_all()[name]
        torch.ops.load_library(str(path))
        _operators[name] = path
    return path

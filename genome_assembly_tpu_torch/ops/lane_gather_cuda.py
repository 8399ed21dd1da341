"""ctypes binding and wrapper of the lane gather kernel (csrc/lane_gather.cu).

Replaces the JAX package's ``tools/bench_prims.py::gk``.  The wrapper
checks what the kernel does not take and raises; it launches on torch's
current stream of the tensors' card (the library sets and restores the
thread's card itself), does not synchronise and allocates only its output.
It does not read the indices back: an index outside its row gives 0 there
(the dispatcher ``ops/lane_gather.lane_gather`` refuses such indices before
it calls this).  Its host path is kept short, because at the probe's sizes
the host's work per launch is longer than the kernel's.  ``launch_count`` goes up by one per launch and nowhere
else, so a run can show that it went through the kernel.

The library is built and loaded at the first launch, never at import.
"""

from __future__ import annotations

import ctypes

import torch

from genome_assembly_tpu_torch.ops import lane_gather

# launches of lane_gather_kernel since import (or since a caller reset it)
launch_count = 0

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from genome_assembly_tpu_torch.csrc import build

        lib = build.load("lane_gather")
        ptr = ctypes.c_void_p
        lib.lane_gather_launch.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int, ptr]
        lib.lane_gather_launch.restype = ctypes.c_int
        lib.lane_gather_max_staged_cols.argtypes = [ctypes.c_int]
        lib.lane_gather_max_staged_cols.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def max_staged_cols(elem_bytes: int) -> int:
    """Columns of the widest row the kernel stages in shared memory; a wider
    row is gathered straight from device memory."""
    return int(_library().lane_gather_max_staged_cols(elem_bytes))


def lane_gather_cuda(x: torch.Tensor, idx: torch.Tensor, *, checked: bool = False
                     ) -> torch.Tensor:
    """``out[r, c] = x[r, idx[r, c]]`` for contiguous CUDA tensors of one
    ``[rows, cols]`` shape (rows, cols >= 1; cols < 2^31), int32 values with
    int32 indices or int64 with int64.  ``checked``: the caller has run
    ``lane_gather.check`` on these tensors (the dispatcher does)."""
    global launch_count
    if not checked:
        lane_gather.check(x, idx)
    if not x.is_cuda:
        raise ValueError("lane_gather_cuda needs CUDA tensors")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError("lane_gather_cuda needs contiguous tensors")
    rows, cols = x.shape
    if rows < 1 or not 1 <= cols < 2 ** 31:
        raise ValueError(f"lane_gather_cuda takes rows >= 1 and 1 <= cols < 2^31, "
                         f"got {tuple(x.shape)}")
    lib = _library()
    card = x.device.index
    out = torch.empty_like(x)
    err = lib.lane_gather_launch(x.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, cols,
                                 x.element_size(), card,
                                 torch._C._cuda_getCurrentRawStream(card))
    if err != 0:
        raise RuntimeError(f"lane_gather kernel launch failed: cudaError {err}")
    launch_count += 1
    return out

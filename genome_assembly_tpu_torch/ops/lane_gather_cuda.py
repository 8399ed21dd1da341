"""Wrapper of the lane gather kernel (csrc/lane_gather.cu): a torch operator.

Replaces the JAX package's ``tools/bench_prims.py::gk``.  The kernel's host
path is C++ (csrc/lane_gather_op.cpp, the operator ``ga_torch::lane_gather``):
one call from Python crosses into torch's dispatcher, and the checks, the
output's allocation, the card's current stream and the launch run there.  It
refuses what the kernel does not take (``ValueError``, ``TypeError``),
launches on torch's current stream of the tensors' card, does not
synchronise and allocates only its output.  It does not read the indices
back: an index outside its row gives 0 there (the dispatcher
``ops/lane_gather.lane_gather`` refuses such indices before it calls this).
``launch_count()`` is kept by the library: one a launch and nowhere else, so
a run can show that it went through the kernel.

The operator library is built (csrc/build.py) and loaded at the first call
on a CUDA tensor, never at import; a CPU tensor is refused before anything
is built.  There is no other route: a failed build or launch raises.
"""

from __future__ import annotations

import torch

# torch.ops.ga_torch.lane_gather.default once the library is loaded
_op = None


def _load():
    global _op
    if _op is None:
        from genome_assembly_tpu_torch.csrc import build

        build.load_operators("lane_gather")
        _op = torch.ops.ga_torch.lane_gather.default
    return _op


def launch_count() -> int:
    """Launches of lane_gather_kernel since the library was loaded or the
    count was reset (0 before the first launch)."""
    return 0 if _op is None else int(torch.ops.ga_torch.lane_gather_launch_count())


def reset_launch_count() -> None:
    if _op is not None:
        torch.ops.ga_torch.lane_gather_reset_launch_count()


def max_staged_cols(elem_bytes: int) -> int:
    """Columns of the widest row the kernel stages in shared memory; a wider
    row is gathered straight from device memory."""
    _load()
    return int(torch.ops.ga_torch.lane_gather_max_staged_cols(elem_bytes))


def lane_gather_cuda(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[r, c] = x[r, idx[r, c]]`` for contiguous CUDA tensors of one
    ``[rows, cols]`` shape (rows, cols >= 1; cols < 2^31), int32 values with
    int32 indices or int64 with int64."""
    op = _op
    if op is None:
        if not x.is_cuda:
            raise ValueError(f"lane_gather_cuda needs CUDA tensors, got {x.device}")
        op = _load()
    return op(x, idx)

"""Row-wise lane gather: ``out[r, c] = x[r, idx[r, c]]`` over ``[rows, cols]``.

The JAX package computes it in one TPU kernel, the ``gk`` probe of its
``tools/bench_prims.py`` (``take_along_axis`` along the rows of a block in
VMEM); no pipeline of either package uses it.  ``lane_gather`` sends a CUDA
tensor to the hand-written kernel (ops/lane_gather_cuda.py, a torch
operator built from csrc/lane_gather.cu and csrc/lane_gather_op.cpp) and a
CPU tensor to ``lane_gather_plain``; there is no other route and no fallback
between the two.

Takes 32-bit values with int32 indices (the probe's uint32 bits held in
int32) or int64 values with int64 indices (the port's keys), both
``[rows, cols]`` on one device, and ``0 <= idx < cols``: the dispatcher
refuses an index outside its row with a ``ValueError`` (one read-back of
the indices' minimum and maximum).
"""

from __future__ import annotations

import torch

# (value dtype, index dtype) pairs the kernel takes
DTYPES = ((torch.int32, torch.int32), (torch.int64, torch.int64))


def check(x: torch.Tensor, idx: torch.Tensor) -> None:
    """What the gather takes, whatever the device: 2-d arrays of one shape on
    one device, in one of ``DTYPES``."""
    if x.dim() != 2 or idx.shape != x.shape:
        raise ValueError(f"lane_gather needs x and idx of one [rows, cols] shape, got "
                         f"{tuple(x.shape)} and {tuple(idx.shape)}")
    if (x.dtype, idx.dtype) not in DTYPES:
        raise TypeError(f"lane_gather takes int32 values with int32 indices or int64 with "
                        f"int64, got {x.dtype} and {idx.dtype}")
    if x.device != idx.device:
        raise ValueError(f"lane_gather needs x and idx on one device, got {x.device} and "
                         f"{idx.device}")


def check_range(idx: torch.Tensor) -> None:
    """Raise unless every index lies in its row: ``0 <= idx < cols``."""
    if idx.numel() == 0:
        return
    lo, hi = torch.aminmax(idx)
    lo, hi = torch.stack([lo, hi]).tolist()
    if lo < 0 or hi >= idx.shape[1]:
        raise ValueError(f"lane_gather: indices must lie in [0, {idx.shape[1]}), "
                         f"got [{lo}, {hi}]")


def lane_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The gather by advanced indexing: ``x[arange(rows)[:, None], idx]``."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx.long()]


def lane_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[r, c] = x[r, idx[r, c]]``: on the card the kernel, on the CPU the
    plain version."""
    check(x, idx)
    check_range(idx)
    if x.is_cuda:
        from genome_assembly_tpu_torch.ops import lane_gather_cuda

        return lane_gather_cuda.lane_gather_cuda(x, idx)
    return lane_gather_plain(x, idx)

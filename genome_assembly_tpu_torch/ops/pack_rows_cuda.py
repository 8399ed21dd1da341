"""ctypes binding and wrapper of K0, the row packer (csrc/pack_rows.cu).

Replaces no TPU kernel (the JAX package pads and encodes on the host; see
the source's note).  The wrapper checks what the kernel does not take and
raises; it launches on torch's current stream, does not synchronise, and
allocates only the rows, every byte of which the kernel writes.
``launch_count`` goes up by one per kernel launch and nowhere else, so a
run can show that it went through the kernel.

The library is built and loaded at the first launch, never at import.
"""

from __future__ import annotations

import ctypes

import torch

# launches of pack_rows_kernel since import (or since a caller reset it)
launch_count = 0

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from genome_assembly_tpu_torch.csrc import build

        lib = build.load("pack_rows")
        lib.pack_rows_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.pack_rows_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def pack_rows_cuda(bases: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor,
                   table: torch.Tensor, width: int) -> torch.Tensor:
    """The rows on the card: bases [N] uint8, starts and lengths [n] int32,
    table [256] uint8, all contiguous CUDA tensors on one device, n >= 1 and
    N < 2^31.  Returns codes [n, width] uint8."""
    global launch_count
    tensors = (bases, starts, lengths, table)
    if not all(t.is_cuda and t.device == bases.device for t in tensors):
        raise ValueError("pack_rows_cuda needs bases, starts, lengths and table on one "
                         "CUDA device")
    dtypes = (torch.uint8, torch.int32, torch.int32, torch.uint8)
    if tuple(t.dtype for t in tensors) != dtypes:
        raise TypeError(
            "pack_rows_cuda needs uint8 bases, int32 starts and lengths and a uint8 table, "
            f"got {', '.join(str(t.dtype) for t in tensors)}")
    n = lengths.shape[0]
    if (bases.dim(), starts.dim(), lengths.dim()) != (1, 1, 1) or starts.shape[0] != n \
            or tuple(table.shape) != (256,):
        raise ValueError(
            f"pack_rows_cuda needs bases [N], starts and lengths [n] and table [256], got "
            f"{', '.join(str(tuple(t.shape)) for t in tensors)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("pack_rows_cuda needs contiguous tensors")
    if n < 1 or width < 1 or bases.numel() >= 2**31:
        raise ValueError(f"pack_rows_cuda takes n >= 1 rows of width >= 1 and fewer than "
                         f"2^31 bases, got n={n} width={width} N={bases.numel()}")
    lib = _library()
    with torch.cuda.device(bases.device):
        codes = torch.empty((n, width), dtype=torch.uint8, device=bases.device)
        err = lib.pack_rows_launch(
            bases.data_ptr(), bases.numel(), starts.data_ptr(), lengths.data_ptr(),
            table.data_ptr(), codes.data_ptr(), n, width,
            torch.cuda.current_stream().cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"pack_rows kernel launch failed: cudaError {err}")
        launch_count += 1
    return codes

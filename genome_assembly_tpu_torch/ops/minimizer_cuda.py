"""ctypes binding and wrapper of the fused scan kernel (csrc/fast_scan.cu).

Replaces the JAX package's ``ops/minimizer_pallas.py::fast_scan_pallas``.
The wrapper checks what the kernel does not take and raises; it launches
on torch's current stream, does not synchronise, and allocates only the
outputs, all three of which the kernel writes (``valid`` too).  ``launch_count`` goes up by one per kernel launch and nowhere
else, so a run can show that it went through the kernel.

The library is built and loaded at the first launch, never at import.
"""

from __future__ import annotations

import ctypes

import torch

from genome_assembly_tpu_torch.ops.minimizer import WindowRecords

# launches of fast_scan_kernel since import (or since a caller reset it)
launch_count = 0

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from genome_assembly_tpu_torch.csrc import build

        lib = build.load("fast_scan")
        lib.fast_scan_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.fast_scan_launch.restype = ctypes.c_int
        lib.fast_scan_max_len.argtypes = []
        lib.fast_scan_max_len.restype = ctypes.c_int
        _lib = lib
    return _lib


def fast_scan_cuda(
    codes: torch.Tensor, lengths: torch.Tensor, *, k: int, m: int
) -> WindowRecords:
    """The scan on the card: codes [B, L] uint8, lengths [B] int32, both
    contiguous CUDA tensors on one device; any B >= 1, L up to the
    kernel's limit (``fast_scan_max_len()``, 8192)."""
    global launch_count
    if not (codes.is_cuda and lengths.is_cuda and codes.device == lengths.device):
        raise ValueError("fast_scan_cuda needs codes and lengths on one CUDA device")
    if codes.dtype != torch.uint8 or lengths.dtype != torch.int32:
        raise TypeError(
            f"fast_scan_cuda needs uint8 codes and int32 lengths, got "
            f"{codes.dtype} and {lengths.dtype}"
        )
    if codes.dim() != 2 or lengths.dim() != 1 or lengths.shape[0] != codes.shape[0]:
        raise ValueError(
            f"fast_scan_cuda needs codes [B, L] and lengths [B], got "
            f"{tuple(codes.shape)} and {tuple(lengths.shape)}"
        )
    if not (codes.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("fast_scan_cuda needs contiguous tensors")
    batch, max_len = codes.shape
    lib = _library()
    if not (1 <= m <= 15 and m <= k <= 31 and k <= max_len):
        raise ValueError(f"need 1 <= m <= 15, m <= k <= 31, k <= L; got k={k} m={m} L={max_len}")
    if batch < 1 or max_len > lib.fast_scan_max_len():
        raise ValueError(
            f"fast_scan_cuda takes B >= 1 and L <= {lib.fast_scan_max_len()}, "
            f"got B={batch} L={max_len}"
        )
    n_win = max_len - k + 1
    with torch.cuda.device(codes.device):
        mmer = torch.empty((batch, n_win), dtype=torch.int32, device=codes.device)
        kmer = torch.empty((batch, n_win), dtype=torch.int64, device=codes.device)
        valid = torch.empty((batch, n_win), dtype=torch.bool, device=codes.device)
        err = lib.fast_scan_launch(
            codes.data_ptr(), lengths.data_ptr(), mmer.data_ptr(), kmer.data_ptr(),
            valid.data_ptr(), batch, max_len, k, m,
            torch.cuda.current_stream().cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"fast_scan kernel launch failed: cudaError {err}")
        launch_count += 1
    return WindowRecords(mmer=mmer, kmer=kmer, valid=valid)

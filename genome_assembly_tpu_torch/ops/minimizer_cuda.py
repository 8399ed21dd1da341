"""Wrapper of the fused scan kernel (csrc/fast_scan.cu), launched by the
torch operator ``ga_torch::fast_scan`` (csrc/fast_scan_op.cpp).

Replaces the JAX package's ``ops/minimizer_pallas.py::fast_scan_pallas``.
The wrapper checks what the kernel does not take and raises, and allocates
only the outputs, all three of which the kernel writes (``valid`` too); the
operator launches on torch's current stream of the tensors' card and does
not synchronise.  ``launch_count`` goes up by one per kernel launch and
nowhere else, so a run can show that it went through the kernel.

The operator library is built and loaded at the first launch, never at
import; a CPU tensor is refused before anything is built.
"""

from __future__ import annotations

import torch

from genome_assembly_tpu_torch.ops.minimizer import WindowRecords

# launches of fast_scan_kernel since import (or since a caller reset it)
launch_count = 0

# The longest row the kernel takes (``fast_scan_max_len()`` of the library).
MAX_LEN = 8192

# torch.ops.ga_torch.fast_scan.default once the library is loaded
_op = None


def _load():
    global _op
    if _op is None:
        from genome_assembly_tpu_torch.csrc import build

        build.load_operators("fast_scan")
        if torch.ops.ga_torch.fast_scan_max_len() != MAX_LEN:
            raise RuntimeError("fast_scan.cu and minimizer_cuda.py disagree on the longest row")
        _op = torch.ops.ga_torch.fast_scan.default
    return _op


def fast_scan_cuda(
    codes: torch.Tensor, lengths: torch.Tensor, *, k: int, m: int
) -> WindowRecords:
    """The scan on the card: codes [B, L] uint8, lengths [B] int32, both
    contiguous CUDA tensors on one device; any B >= 1, L up to the
    kernel's limit (``MAX_LEN``)."""
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
    op = _load()
    if not (1 <= m <= 15 and m <= k <= 31 and k <= max_len):
        raise ValueError(f"need 1 <= m <= 15, m <= k <= 31, k <= L; got k={k} m={m} L={max_len}")
    if batch < 1 or max_len > MAX_LEN:
        raise ValueError(
            f"fast_scan_cuda takes B >= 1 and L <= {MAX_LEN}, "
            f"got B={batch} L={max_len}"
        )
    n_win = max_len - k + 1
    mmer = torch.empty((batch, n_win), dtype=torch.int32, device=codes.device)
    kmer = torch.empty((batch, n_win), dtype=torch.int64, device=codes.device)
    valid = torch.empty((batch, n_win), dtype=torch.bool, device=codes.device)
    op(codes, lengths, mmer, kmer, valid, batch, max_len, k, m)
    launch_count += 1
    return WindowRecords(mmer=mmer, kmer=kmer, valid=valid)

"""Canonical k-mer + minimizer scan over read batches (fast mode).

``fast_scan`` is the public function: on a CUDA tensor it launches the
hand-written kernel (ops/minimizer_cuda.py, csrc/fast_scan.cu) or raises;
on a CPU tensor it runs ``fast_scan_plain``, the same function written
with tensor ops.  The plain version is what the CPU tests hold against
the JAX package and what the kernel is held against on the card.

Record convention: one int64 key per window (ops/encode.py) and one int32
m-mer score.  Windows that do not exist (start + k > read length) hold
``SENTINEL`` / ``MMER_SENTINEL``: the masking that ``count_keys`` applies
next is folded into the scan.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from genome_assembly_tpu_torch.common import MMER_SENTINEL, SENTINEL
from genome_assembly_tpu_torch.ops import encode


class WindowRecords(NamedTuple):
    """Per-window records of a read batch; all tensors are [batch, n_windows].

    mmer: int32 minimizer of the window (min over its m-mers of
      min(m-mer, reverse complement)); MMER_SENTINEL where not valid.
    kmer: int64 canonical k-mer key; SENTINEL where not valid.
    valid: window exists (window start + k <= read length).
    """

    mmer: torch.Tensor
    kmer: torch.Tensor
    valid: torch.Tensor


def fast_scan_plain(
    codes: torch.Tensor, lengths: torch.Tensor, *, k: int, m: int
) -> WindowRecords:
    """The scan in plain tensor ops, on whatever device ``codes`` is on.

    The canonical form of a window is the smaller packed value of the
    k-mer and its reverse complement.  The minimizer is the minimum over
    the window's k - m + 1 m-mer positions of min(fwd, rc) -- the minimum
    VALUE, so ties need no rule; it is strand-symmetric.
    """
    batch, max_len = codes.shape
    n_win = max_len - k + 1
    if not (1 <= m <= 15 and m <= k <= 31 and n_win >= 1):
        raise ValueError(f"need 1 <= m <= 15, m <= k <= 31, k <= L; got k={k} m={m} L={max_len}")

    n_mpos = max_len - m + 1
    fwd = encode._windowed_pack(encode._doubling_packs(codes, m), m, n_mpos)
    rc_m = encode._windowed_rc_pack(encode._doubling_rc_packs(codes, m), m, n_mpos)
    canon_m = torch.minimum(fwd, rc_m)

    # windowed min over the k - m + 1 m-mer positions of each window
    wmin = canon_m.unfold(1, k - m + 1, 1).amin(dim=2)

    key, rc_key = encode.pack_kmers_both(codes, k)
    canon = torch.minimum(key, rc_key)

    starts = torch.arange(n_win, device=codes.device)
    valid = starts[None, :] + k <= lengths[:, None]
    return WindowRecords(
        mmer=torch.where(valid, wmin, MMER_SENTINEL).to(torch.int32),
        kmer=torch.where(valid, canon, SENTINEL),
        valid=valid,
    )


def fast_scan(
    codes: torch.Tensor, lengths: torch.Tensor, *, k: int, m: int
) -> WindowRecords:
    """Canonical scan of a read batch: codes [B, L] uint8, lengths [B] int32.

    CUDA tensors go through the kernel, CPU tensors through the plain
    version; there is no other route and no fallback between the two.
    """
    if codes.is_cuda:
        from genome_assembly_tpu_torch.ops import minimizer_cuda

        return minimizer_cuda.fast_scan_cuda(codes, lengths, k=k, m=m)
    return fast_scan_plain(codes, lengths, k=k, m=m)

"""Window scans over read batches: fast mode's canonical scan and parity
mode's reference-exact signature scan.

``fast_scan`` is the fast-mode scan: on a CUDA tensor it launches the
hand-written kernel (ops/minimizer_cuda.py, csrc/fast_scan.cu) or raises;
on a CPU tensor it runs ``fast_scan_plain``, the same function written
with tensor ops.  The plain version is what the CPU tests hold against
the JAX package and what the kernel is held against on the card.

``parity_scan`` replicates the reference's per-read signature recurrence
exactly, stale signature included: a window's signature is chosen by a
full rescan of its m-mer positions only when the previous signature's
start has fallen behind the window start; m-mers entering on the right
are otherwise ignored.  The JAX package has no kernel for it either (a
``lax.scan`` of plain ``jnp``); here it is plain tensor code on both
devices, one elementwise step a window position across the whole batch.

Record convention: one int64 key per window (ops/encode.py) and one int32
m-mer score.  Windows that do not exist (start + k > read length) hold
``SENTINEL`` / ``MMER_SENTINEL``: the masking that the count applies next
is folded into the scan.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from genome_assembly_tpu_torch.common import MMER_SENTINEL, SENTINEL
from genome_assembly_tpu_torch.ops import encode


class WindowRecords(NamedTuple):
    """Per-window records of a read batch; all tensors are [batch, n_windows].

    mmer: int32; MMER_SENTINEL where not valid.  Fast mode: the window's
      minimizer (min over its m-mers of min(m-mer, reverse complement)).
      Parity mode: the stored signature m-mer (complemented when the
      window's strand flag is set), not a minimizer.
    kmer: int64 key; SENTINEL where not valid.  Fast mode: the canonical
      k-mer.  Parity mode: the stored k-mer (complemented, without
      reversal, when the strand flag is set).
    valid: window exists (window start + k <= read length).
    """

    mmer: torch.Tensor
    kmer: torch.Tensor
    valid: torch.Tensor


def _window_min(x: torch.Tensor, width: int) -> torch.Tensor:
    """Min over each run of ``width`` consecutive columns of x [B, n]:
    [B, n - width + 1].  Doubling: spans of 1, 2, 4 ... columns, then the
    two overlapping largest spans that cover a window."""
    n_out = x.shape[1] - width + 1
    span = 1
    while span * 2 <= width:
        x = torch.minimum(x[:, :-span], x[:, span:])
        span *= 2
    return torch.minimum(x[:, :n_out], x[:, width - span: width - span + n_out])


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
    # one pair of pyramids serves the m-mers and the k-mers (m <= k)
    packs, rc_packs = encode._doubling_packs(codes, k), encode._doubling_rc_packs(codes, k)
    fwd = encode._windowed_pack(packs, m, n_mpos)
    rc_m = encode._windowed_rc_pack(rc_packs, m, n_mpos)
    canon_m = torch.minimum(fwd, rc_m).to(torch.int32)  # m <= 15: 30 bits
    wmin = _window_min(canon_m, k - m + 1)

    canon = torch.minimum(encode._windowed_pack(packs, k, n_win),
                          encode._windowed_rc_pack(rc_packs, k, n_win))

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


def _signature_positions(mx: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """The sequential signature recurrence, for every read of a batch.

    mx: [batch, n_mpos] max(fwd, comp) score of each m-mer start position.
    Returns sig_pos [batch, n_windows] int64.

    A rescan at window i picks ``fresh[i] = i + argmax(mx[i : i + k - m + 1])``
    (the first maximum, as the reference's strict-greater update does;
    ``torch.argmax`` returns the first index of a tie on both devices).
    Every window's fresh position is computed at once; the carry then walks
    the windows, one elementwise step a position across the batch: the
    signature stays until it falls behind the window start.
    """
    wwin = k - m + 1
    fresh = mx.unfold(1, wwin, 1).argmax(dim=2)
    n_win = fresh.shape[1]
    fresh += torch.arange(n_win, device=mx.device)
    out = torch.empty_like(fresh)
    cur = torch.full_like(fresh[:, 0], -1)
    for i in range(n_win):
        cur = torch.where(cur < i, fresh[:, i], cur)
        out[:, i] = cur
    return out


def parity_scan(
    codes: torch.Tensor, lengths: torch.Tensor, *, k: int, m: int
) -> WindowRecords:
    """Reference-exact signature scan of a read batch: codes [B, L] uint8
    (the reference's code table), lengths [B] int32.

    The strand flag at the signature is ``comp >= fwd`` (a tie picks the
    complement); when set, both the signature and the k-mer are stored
    complemented, without reversal.
    """
    if k < 2 * m:
        raise ValueError(f"parity scan requires k >= 2m; got k={k} m={m}")
    max_len = codes.shape[1]
    n_win = max_len - k + 1
    if not (1 <= m <= 15 and k <= 31 and n_win >= 1):
        raise ValueError(f"need 1 <= m <= 15, 2m <= k <= 31, k <= L; got k={k} m={m} L={max_len}")
    mask = (1 << (2 * m)) - 1

    fwd = encode.windowed_scores(codes, m)
    mx = torch.maximum(fwd, mask - fwd)
    sig_pos = _signature_positions(mx, k, m)
    del mx
    fwd_at_sig = fwd.gather(1, sig_pos)
    del fwd, sig_pos
    comp_at_sig = mask - fwd_at_sig
    is_rev = comp_at_sig >= fwd_at_sig
    mmer = torch.where(is_rev, comp_at_sig, fwd_at_sig)

    key = encode.pack_kmers(codes, k)
    key = torch.where(is_rev, encode.complement_packed(key, k), key)

    starts = torch.arange(n_win, device=codes.device)
    valid = starts[None, :] + k <= lengths[:, None]
    return WindowRecords(
        mmer=torch.where(valid, mmer, MMER_SENTINEL),
        kmer=torch.where(valid, key, SENTINEL),
        valid=valid,
    )

"""Super-k-mer records: compressed staging for the out-of-core count.

Consecutive windows of a read that share one minimizer form a SUPER-K-MER
spanning s + k - 1 bases.  Staging those bases once, 2-bit packed, costs
24 B a record where the plain out-of-core count stages 8 B a window, so a
re-scan pass extracts several times more partitions within one staging
budget, and the pass count drops.

Correctness: ``fast_scan``'s minimizer is a strand-symmetric function of
the window's k bases, so every occurrence of a canonical k-mer has the same
minimizer; partitioning records by a hash of the minimizer keeps each
k-mer's occurrences in one partition (the KMC signature argument).
Expansion runs ``fast_scan`` itself on the rebuilt base rows, so the keys
it gives are the source scan's.  Both functions launch K1 on a CUDA tensor
(the batch, then the rebuilt rows ``[n, S_CAP + k - 1]``).

Record layout (four lanes, flat ``[batch * n_windows]``, a record at each
run-start window slot):

  mmer int32 | s int32 | w0 int64 | w1 int64          (24 B)

``mmer`` is ``MMER_SENTINEL`` at a slot that holds no record -- the ONLY
lane that says so (a word of 32 A bases is all ones); the other lanes hold
0 there.  s <= S_CAP windows (longer runs split every S_CAP windows from
the run's start).  w0 packs bases 0..31 of the span 2-bit little-endian,
w1 bases 32..span-1 (bits past the span are 0).  The JAX package's six
uint32 lanes (mmer, s, b0..b3, SENTINEL everywhere at a non-record slot)
are (mmer, s, w0 & M, w0 >> 32, w1 & M, w1 >> 32); ``convert`` maps
between the two.
"""

from __future__ import annotations

import torch

from genome_assembly_tpu_torch.common import MMER_SENTINEL
from genome_assembly_tpu_torch.ops import minimizer

S_CAP = 25  # windows a record; span = S_CAP + k - 1 <= 55 bases (k <= 31)
LANES = 4  # mmer, s, w0, w1
RECORD_BYTES = 24  # 4 + 4 + 8 + 8, the JAX package's 6 x 4

# each lane's dtype, and its value at a slot that holds no record
DTYPES = (torch.int32, torch.int32, torch.int64, torch.int64)
FILLS = (MMER_SENTINEL, 0, 0, 0)


def _bases_mask(n: int) -> int:
    """The low 2n bits of an int64 word (n <= 32 bases)."""
    return -1 if n >= 32 else (1 << (2 * n)) - 1


def _packed_words(codes: torch.Tensor, n_win: int, span: int):
    """(w0, w1) [B, n_win]: bases [j, j + span) of each row packed 2-bit
    little-endian, columns past the row zero.  Five doubling steps build
    every 32-base word at once; w1 is the word 32 columns on."""
    batch = codes.shape[0]
    p = torch.cat([codes.long(), codes.new_zeros((batch, 64)).long()], dim=1)
    for level in (1, 2, 4, 8, 16):
        p = p[:, :-level] | (p[:, level:] << (2 * level))
    w0 = p[:, :n_win] & _bases_mask(min(32, span))
    if span <= 32:
        return w0, torch.zeros_like(w0)
    return w0, p[:, 32: 32 + n_win] & _bases_mask(span - 32)


def super_records(codes: torch.Tensor, lengths: torch.Tensor, *, k: int, m: int):
    """One batch's super-k-mer records, flat [batch * n_windows] lanes.

    codes [B, L] uint8, lengths [B] int32.  Returns (mmer, s, w0, w1): a
    record at each run-start window slot.  Runs are maximal stretches of
    consecutive valid windows with equal ``fast_scan`` minimizer, split
    every S_CAP windows.  The JAX package's three associative scans are a
    prefix max (``cummax``) and a suffix min (``cummin`` of the flipped
    tensor); its loop over the span's bases is five shifted ORs.
    """
    if k > 31:
        raise ValueError("super-k-mer staging supports k <= 31")
    batch, max_len = codes.shape
    n_win = max_len - k + 1
    recs = minimizer.fast_scan(codes, lengths, k=k, m=m)
    mm = recs.mmer  # MMER_SENTINEL where the window is not valid

    idx = torch.arange(n_win, dtype=torch.int64, device=codes.device)[None, :]
    # raw run starts: the first window, a minimizer change, a validity change
    raw_start = torch.cat(
        [torch.ones((batch, 1), dtype=torch.bool, device=codes.device),
         mm[:, 1:] != mm[:, :-1]], dim=1)
    raw_start_idx = torch.where(raw_start, idx, -1).cummax(dim=1).values
    # split long runs every S_CAP windows from the raw start
    start = raw_start | ((idx - raw_start_idx) % S_CAP == 0)
    del raw_start, raw_start_idx
    # the next start (or the end of the valid prefix) bounds each length
    suffix_min = torch.where(start, idx, n_win).flip(1).cummin(dim=1).values.flip(1)
    next_start = torch.cat(
        [suffix_min[:, 1:], suffix_min.new_full((batch, 1), n_win)], dim=1)
    del suffix_min
    n_valid = torch.clamp(lengths.long() - k + 1, min=0)[:, None]
    slen = torch.clamp(torch.minimum(next_start, n_valid) - idx, 0, S_CAP)
    del next_start

    w0, w1 = _packed_words(codes, n_win, S_CAP + k - 1)
    is_rec = start & recs.valid
    return (
        torch.where(is_rec, mm, MMER_SENTINEL).reshape(-1),
        torch.where(is_rec, slen, 0).to(torch.int32).reshape(-1),
        torch.where(is_rec, w0, 0).reshape(-1),
        torch.where(is_rec, w1, 0).reshape(-1),
    )


def record_rows(mmer, slen, w0, w1, *, k: int):
    """The records' base rows: (codes [n, S_CAP + k - 1] uint8, lengths [n]
    int32 = s + k - 1, 0 for a slot that holds no record)."""
    span = S_CAP + k - 1
    j0 = torch.arange(min(32, span), dtype=torch.int64, device=w0.device)
    cols = [(w0[:, None] >> (2 * j0)) & 3]
    if span > 32:
        j1 = torch.arange(span - 32, dtype=torch.int64, device=w1.device)
        cols.append((w1[:, None] >> (2 * j1)) & 3)
    codes = torch.cat(cols, dim=1).to(torch.uint8)
    lengths = torch.where(mmer != MMER_SENTINEL, slen + (k - 1), 0).to(torch.int32)
    return codes, lengths


def expand_records(mmer, slen, w0, w1, *, k: int, m: int) -> torch.Tensor:
    """Rebuild the records' base rows and scan them again.

    Returns the canonical keys, flat [n * S_CAP] int64 (SENTINEL past each
    record's s windows and for non-record slots): the source scan's keys
    for those windows, since ``fast_scan`` runs on the rebuilt bases.  On a
    CUDA tensor n must be >= 1 (K1 takes no empty batch).
    """
    codes, lengths = record_rows(mmer, slen, w0, w1, k=k)
    return minimizer.fast_scan(codes, lengths, k=k, m=m).kmer.reshape(-1)

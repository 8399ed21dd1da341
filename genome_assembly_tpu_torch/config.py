"""Runtime configuration for the assembly pipeline.

Same fields and checks as the JAX package's ``PipelineConfig``, with two
differences.  There is no ``pallas_scan``: on a CUDA tensor the
hand-written kernel IS the scan.  ``pallas_sort`` is called
``hybrid_sort`` here, because nothing in this package is Pallas: it sends
the count sort through the bitonic kernels (``ops/bitonic_sort.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static configuration of one assembly run.

    Attributes:
      k: k-mer window size.  ``k <= 31`` so a k-mer packs into 62 bits (one
        int64 key); parity mode needs ``k >= 2*m``.
      m: minimizer (m-mer) size, ``m <= 15``.
      abundance_cutoff: keep a k-mer iff its occurrence count is strictly
        greater than this.
      read_length: parity-mode line buffer size (unused by fast mode).
      parity: True -> replicate the reference binary bit for bit; False ->
        fast mode with true canonical minimizers (the only mode ported).
      batch_reads: number of reads per device batch (padded).
      max_read_len: padded read length on device.
      outofcore_bytes: fast mode: record bytes above which counting goes
        out of core.
      link_budget_bytes: fast mode: per-partition byte budget for
        out-of-core link building.
      bulk_jump_states: fast mode: state count above which pointer jumping
        switches to its low-memory per-round form.
      wide_state_ids: distributed extension: carry dBG state ids as wide
        (shard, local) pairs; "auto" switches at 2**31 padded states.
      hybrid_sort: fast mode: sort the counted keys with library sorts of
        chunks merged by the hand-written bitonic kernels
        (``ops/bitonic_sort.sort_keys_hybrid``) instead of one library
        sort.  Counterpart of the JAX package's ``pallas_sort``; same
        result, off by default.
    """

    k: int = 31
    m: int = 4
    abundance_cutoff: int = 1
    read_length: int = 101
    parity: bool = True
    batch_reads: int = 4096
    max_read_len: int = 128
    outofcore_bytes: int = 3 << 30
    link_budget_bytes: int = 1 << 30
    bulk_jump_states: int = 1 << 26
    wide_state_ids: object = "auto"
    hybrid_sort: bool = False

    def __post_init__(self) -> None:
        if not (1 <= self.m <= 15):
            raise ValueError(f"m must be in [1, 15], got {self.m}")
        if not (self.m <= self.k <= 31):
            raise ValueError(f"k must be in [m, 31], got k={self.k} m={self.m}")
        if self.parity and self.k < 2 * self.m:
            raise ValueError(
                "parity mode requires k >= 2*m (the reference's incremental "
                f"branch is dead code only in that regime); got k={self.k} "
                f"m={self.m}"
            )
        if self.abundance_cutoff < 0:
            raise ValueError("abundance_cutoff must be >= 0")
        if self.max_read_len < self.k:
            raise ValueError("max_read_len must be >= k")
        if self.wide_state_ids not in (True, False, "auto"):
            raise ValueError(
                f"wide_state_ids must be True, False, or 'auto'; got "
                f"{self.wide_state_ids!r}"
            )

    @property
    def windows_per_read(self) -> int:
        """Max k-mer windows in a padded read."""
        return self.max_read_len - self.k + 1

    @property
    def mmer_mask(self) -> int:
        """4**m - 1: max m-mer score, also the complement mask."""
        return (1 << (2 * self.m)) - 1

    def kmer_split(self) -> Tuple[int, int]:
        """(n_hi, n_lo) bases in the hi/lo 32-bit halves of the JAX
        package's lane pair; the int64 key here is ``(hi << 32) | lo``."""
        n_lo = min(self.k, 16)
        return self.k - n_lo, n_lo

"""The least time the card could take for a kernel's work.

The peak is NVIDIA's data sheet for the H100 SXM at its 700 W limit: 3.35 TB/s
of HBM3.  ``scan_bytes`` is the bytes part of the port's
``chip_smoke.scan_bound`` (frozen here): K1, ``fast_scan_kernel``, reads each
input once and writes each output once.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12


def scan_bytes(rows: int, max_len: int, k: int) -> int:
    """Bytes K1 moves on one batch of ``rows`` reads padded to ``max_len``:
    the codes (1 B a base) and lengths (4 B a read) read, and per window
    slot the minimizer (4 B), the k-mer (8 B) and the valid flag (1 B)
    written."""
    n_win = max_len - k + 1
    return rows * max_len + 4 * rows + 13 * rows * n_win

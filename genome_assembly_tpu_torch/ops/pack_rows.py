"""The row packer: a fast-mode batch of reads, given as their ASCII bases
one after another, becomes the zero-padded rows of 2-bit codes that the scan
reads (``codes [n, width]`` uint8, as ``io/reads.batch_reads`` builds them on
the host).

Tensor operations on whatever device holds the bases: on a card the stager
(``io/stream``) runs them on its side stream, where they hide under the
copies the scan already waits on, so a hand-written kernel in their place
gains nothing end to end.  No TPU kernel does this either: the JAX package
pads and encodes on the host.  ``pack_rows_plain`` takes the start of each
read among the bases (``io/reads.FlatBatch.starts``) and the encoding table
(``encode._ASCII_TO_CODE``, ``ascii_table``), so the device uses the host's
table.
"""

from __future__ import annotations

import torch

from genome_assembly_tpu_torch.ops import encode


def ascii_table(device) -> torch.Tensor:
    """Fast mode's encoding table (``encode._ASCII_TO_CODE``) on ``device``.
    To a card it is copied from pinned memory on the current stream, without
    synchronising (a copy from pageable memory would wait for the stream)."""
    table = torch.from_numpy(encode._ASCII_TO_CODE)
    if torch.device(device).type != "cuda":
        return table.to(device)
    return table.pin_memory().to(device, non_blocking=True)


def pack_rows_plain(bases: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor,
                    table: torch.Tensor, width: int) -> torch.Tensor:
    """codes [n, width] uint8 of a batch's bases: column c of row r is
    ``table[bases[starts[r] + c]]`` below the row's length (clamped to
    [0, width]) where that base exists, else 0.  Nothing in it reads the
    device back, so on a card it does not synchronise."""
    codes = torch.zeros((lengths.shape[0], width), dtype=torch.uint8, device=bases.device)
    if bases.numel() == 0:
        return codes
    cols = torch.arange(width, device=bases.device)
    pos = starts.long()[:, None] + cols
    inside = (cols < lengths.long().clamp(0, width)[:, None]) & (pos >= 0) & (
        pos < bases.numel())
    looked_up = table[bases[pos.clamp(0, bases.numel() - 1)].long()]
    return torch.where(inside, looked_up, codes)

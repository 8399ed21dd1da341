"""Counter-based virtual genome: bases as a pure function of position.

A synthetic random genome is a pseudo-random function of position, so it
need not be stored: ``base(p) = mix(seed, p) & 3`` with a double-fmix32
counter hash gives any read's bases straight from its start position, on
the device, with no genome array, no gather and no read copied from the
host.  Overlapping reads agree on their shared bases as they would against
a stored genome.  The composition is bijective in ``p`` for a fixed seed,
so the four bases are uniform over any 2^32-aligned window.

``genome_bases`` and ``read_batch`` are the JAX package's
(``ops/vgenome.py``) bit for bit.  Positions are 32-bit values held in
int64 (0 <= p < 2^32; each add and multiply is masked to 32 bits as the
uint32 original wraps), so starts past 2^31 give the same bases.

``read_starts`` has no JAX counterpart: it draws a batch's read starts as a
counter hash of (seed, batch index, read index), a pure function of the
batch index on any device, so a pass that makes a batch again makes the
same reads.  (The JAX scale tool draws them with ``jax.random``, which
torch cannot reproduce; the two tools' datasets are different, same-shaped
datasets.)
"""

from __future__ import annotations

import torch

from genome_assembly_tpu_torch.common import MASK32, fmix32

# Seed diffusion constant of the bases (the JAX package's): distinct from
# the count and link partition-hash families, so genome bases never
# correlate with partition ownership.
SEED_MIX = 0x9E3779B9

# Seed diffusion constant of the read starts (xxHash PRIME32_2): distinct
# from SEED_MIX, so a read's start never correlates with the bases at the
# position equal to its index.
START_MIX = 0x85EBCA77


def _seed_word(seed: int, mix: int) -> int:
    return ((int(seed) * mix) & MASK32) | 1


def genome_bases(seed: int, positions: torch.Tensor) -> torch.Tensor:
    """Bases (codes 0..3, T=0 G=1 C=2 A=3 as ops/encode.py) at ``positions``
    (integer tensor of values in [0, 2^32), any shape) of the virtual genome
    ``seed``; uint8, on the positions' device."""
    s = _seed_word(seed, SEED_MIX)
    h = fmix32((positions.long() & MASK32) ^ s)
    h = fmix32((h + s) & MASK32)
    return (h & 3).to(torch.uint8)


def read_batch(seed: int, starts: torch.Tensor, read_len: int) -> torch.Tensor:
    """[batch, read_len] base codes (uint8) for reads starting at ``starts``
    (positions in [0, 2^32)) of the virtual genome ``seed``."""
    offs = torch.arange(read_len, dtype=torch.int64, device=starts.device)
    return genome_bases(seed, (starts.long()[:, None] + offs[None, :]) & MASK32)


def read_starts(seed: int, batch_index: int, batch: int, span: int,
                device="cuda") -> torch.Tensor:
    """[batch] int64 read starts in [0, span) of batch ``batch_index``:
    ``fmix32(fmix32(read ^ fmix32(batch_index ^ s)) + s) mod span`` with
    ``s`` the seed word.  span must be in [1, 2^32]; a 32-bit hash reduced
    modulo span is biased by less than span / 2^32, which synthetic reads
    can bear."""
    if not 1 <= span <= 1 << 32:
        raise ValueError(f"read start span {span} is not in [1, 2^32]")
    s = _seed_word(seed, START_MIX)
    # the batch's word on the host: a Python int, nothing copied to the device
    b = int(fmix32(torch.tensor((int(batch_index) & MASK32) ^ s)))
    r = torch.arange(batch, dtype=torch.int64, device=device)
    h = fmix32((fmix32(r ^ b) + s) & MASK32)
    return h % span

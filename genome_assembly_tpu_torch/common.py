"""Shared scalar constants and the key-hash mixer, in int64 form.

The JAX package carries every 32-bit quantity as uint32.  torch on the
CPU has no shifts or compares for uint32, so here a 32-bit value lives in
the low half of an int64 and every multiply is followed by
``& 0xFFFFFFFF``.  The results are pinned equal to the numpy-uint32
originals (tests/test_torch_count.py): partition and shard contents
depend on these hashes bit for bit.
"""

from __future__ import annotations

import torch

# Padding / invalid key.  A packed k-mer (k <= 31) is below 2^62, so int64
# max sorts after every real key under signed order.  (The JAX package's
# all-ones lane pair would be -1 as int64 and sort FIRST.)
SENTINEL = torch.iinfo(torch.int64).max

# Padding m-mer score: real scores are < 2^30 and travel as int32.
MMER_SENTINEL = torch.iinfo(torch.int32).max

MASK32 = 0xFFFFFFFF

# Multiplicative mixing constants for key -> owner hashing.  The two MUST
# differ (equal constants make (x*A)^(x*B) identically zero).
HASH_A = 2654435761  # Knuth golden ratio, 0x9E3779B1
HASH_B = 0x85EBCA6B  # Murmur3 fmix32

# Independent constants for the link-building partition hash: a k-mer
# whose leading base is T (code 0) packs to the same value as its
# (k-1)-mer suffix, so count and link partitioning must not share a hash.
LINK_HASH_A = 0xC2B2AE35  # Murmur3 fmix32 second constant
LINK_HASH_B = 0x27D4EB2F  # xxHash PRIME32_4

_FMIX_C1 = 0x85EBCA6B
_FMIX_C2 = 0xC2B2AE35


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer on 32-bit values held in int64 (0 <= x < 2^32).

    The products stay below 2^64 and wrap in int64 exactly as uint64
    would; masking to the low 32 bits after each multiply gives the
    uint32 result.
    """
    x = x ^ (x >> 16)
    x = (x * _FMIX_C1) & MASK32
    x = x ^ (x >> 13)
    x = (x * _FMIX_C2) & MASK32
    x = x ^ (x >> 16)
    return x

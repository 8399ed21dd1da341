"""Base-pair codec and 2-bit packing primitives.

Encoding convention (same as the JAX package): codes are T=0, G=1, C=2,
A=3; the base-4 MSB-first "score" of a string equals its 2-bit packed
integer.  The complement of a code c is ``3 - c``; parity mode uses the
reference's per-position complement WITHOUT reversal (``complement``,
``complement_packed``), fast mode the true reverse complement.

A k-mer with k <= 31 packs into at most 62 bits and is carried as ONE
int64 key, the plain MSB-first packed value.  The JAX package splits the
same value into two uint32 lanes (``hi`` = first ``k - min(k, 16)``
bases, ``lo`` = last ``min(k, 16)`` bases); ``key == (hi << 32) | lo``
for every k <= 31, and signed int64 order equals its (hi, lo) order.
"""

from __future__ import annotations

import numpy as np
import torch

# Base characters indexed by numeric code.
BASE_BY_CODE = "TGCA"

# ASCII -> code lookup. Unknown characters map to 3 ('A'); as a
# convenience for fast-mode inputs, lowercase acgt also map to their real
# codes (the parity table below does not).
_ASCII_TO_CODE = np.full(256, 3, dtype=np.uint8)
for _i, _ch in enumerate(BASE_BY_CODE):
    _ASCII_TO_CODE[ord(_ch)] = _i
    _ASCII_TO_CODE[ord(_ch.lower())] = _i

# Reference-exact table: only uppercase TGCA are real; every other byte
# (including lowercase acgt and 'N') scores as 3.
_ASCII_TO_CODE_REF = np.full(256, 3, dtype=np.uint8)
for _i, _ch in enumerate(BASE_BY_CODE):
    _ASCII_TO_CODE_REF[ord(_ch)] = _i

_CODE_TO_ASCII = np.frombuffer(BASE_BY_CODE.encode(), dtype=np.uint8).copy()


def encode_bytes(ascii_u8: torch.Tensor) -> torch.Tensor:
    """Map ASCII bytes to 2-bit codes (uint8), on the tensor's device."""
    table = torch.from_numpy(_ASCII_TO_CODE).to(ascii_u8.device)
    return table[ascii_u8.long()]


def decode_codes(codes: torch.Tensor) -> torch.Tensor:
    """Map 2-bit codes back to ASCII bytes (uint8), on the tensor's device."""
    table = torch.from_numpy(_CODE_TO_ASCII).to(codes.device)
    return table[codes.long()]


def complement(codes: torch.Tensor) -> torch.Tensor:
    """Per-position complement, no reversal: code -> 3 - code."""
    return (3 - codes.long()).to(codes.dtype)


def windowed_scores(codes: torch.Tensor, n: int) -> torch.Tensor:
    """Packed base-4 MSB-first scores of every length-``n`` window (int32).

    The reference's score of each substring.  ``codes`` has shape
    [..., L]; the result has shape [..., L - n + 1].  Requires n <= 15, so
    a score fits 30 bits.
    """
    if not 1 <= n <= 15:
        raise ValueError(f"windowed_scores supports 1 <= n <= 15, got {n}")
    length = codes.shape[-1]
    nwin = length - n + 1
    if nwin <= 0:
        raise ValueError(f"window {n} longer than sequence {length}")
    wide = codes.int()
    acc = wide[..., :nwin]
    for j in range(1, n):
        acc = (acc << 2) | wide[..., j : j + nwin]
    return acc


def _doubling_packs(codes: torch.Tensor, max_span: int) -> dict:
    """Windowed packed values for power-of-two window sizes.

    packs[s][..., i] = 2-bit pack of codes[i : i + s] for s = 1, 2, 4, ...
    up to the largest power of two <= min(max_span, 16), as int64.  Each
    level combines two half-windows with one shift+or.
    """
    length = codes.shape[-1]
    packs = {1: codes.long()}
    s = 1
    while 2 * s <= min(max_span, 16):
        half = packs[s]
        n = length - 2 * s + 1
        packs[2 * s] = (half[..., :n] << (2 * s)) | half[..., s : s + n]
        s *= 2
    return packs


def _windowed_pack(packs: dict, n: int, nwin: int) -> torch.Tensor:
    """Length-``n`` windowed pack (n <= 31) from the doubling pyramid."""
    acc = None
    offset = 0
    for s in sorted(packs, reverse=True):
        if s & n:
            piece = packs[s][..., offset : offset + nwin]
            acc = piece if acc is None else (acc << (2 * s)) | piece
            offset += s
    return acc if acc is not None else torch.zeros_like(packs[1][..., :nwin])


def _doubling_rc_packs(codes: torch.Tensor, max_span: int) -> dict:
    """Reverse-complement analogue of _doubling_packs.

    rcpacks[s][..., i] = 2-bit pack of reverse_complement(codes[i : i + s]).
    Combine rule: rc(A+B) = rc(B)+rc(A), so each level swaps the halves.
    """
    length = codes.shape[-1]
    packs = {1: 3 - codes.long()}
    s = 1
    while 2 * s <= min(max_span, 16):
        half = packs[s]
        n = length - 2 * s + 1
        packs[2 * s] = (half[..., s : s + n] << (2 * s)) | half[..., :n]
        s *= 2
    return packs


def _windowed_rc_pack(rcpacks: dict, n: int, nwin: int) -> torch.Tensor:
    """Length-``n`` windowed reverse-complement pack from the rc pyramid.

    Pieces at increasing offsets land at increasingly significant bits
    (rc reverses piece order)."""
    acc = None
    offset = 0
    len_acc = 0
    for s in sorted(rcpacks, reverse=True):
        if s & n:
            piece = rcpacks[s][..., offset : offset + nwin]
            acc = piece if acc is None else (piece << (2 * len_acc)) | acc
            offset += s
            len_acc += s
    return acc if acc is not None else torch.zeros_like(rcpacks[1][..., :nwin])


def _check_k(codes: torch.Tensor, k: int) -> int:
    if not 1 <= k <= 31:
        raise ValueError(f"k-mer packing supports 1 <= k <= 31, got {k}")
    nwin = codes.shape[-1] - k + 1
    if nwin <= 0:
        raise ValueError(f"k={k} longer than sequence {codes.shape[-1]}")
    return nwin


def pack_kmers_both(
    codes: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(key, rc_key) for every k-window, from shared pyramids; int64.

    rc_key holds the true reverse complement of each window.
    """
    nwin = _check_k(codes, k)
    key = _windowed_pack(_doubling_packs(codes, k), k, nwin)
    rc_key = _windowed_rc_pack(_doubling_rc_packs(codes, k), k, nwin)
    return key, rc_key


def pack_kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Pack every length-``k`` window into one int64 key, MSB-first.

    Shapes: [..., L] -> [..., L - k + 1].
    """
    nwin = _check_k(codes, k)
    return _windowed_pack(_doubling_packs(codes, k), k, nwin)


def complement_packed(key: torch.Tensor, k: int) -> torch.Tensor:
    """Complement of packed k-mers without reversal: each 2-bit group
    c -> 3 - c, i.e. XOR with the all-ones 2k-bit mask; any shape."""
    return key ^ ((1 << (2 * k)) - 1)


def reverse_complement_u32(v: torch.Tensor, n: int) -> torch.Tensor:
    """True reverse complement of packed n-mers (n <= 15) held in any
    integer dtype; elementwise, same dtype out."""
    comp = ((1 << (2 * n)) - 1) - v
    out = torch.zeros_like(v)
    for j in range(n):
        out = out | (((comp >> (2 * j)) & 3) << (2 * (n - 1 - j)))
    return out


def reverse_complement_packed(key: torch.Tensor, k: int) -> torch.Tensor:
    """True reverse complement of packed k-mers; elementwise, any shape."""
    comp = ((1 << (2 * k)) - 1) - key
    out = torch.zeros_like(key)
    for j in range(k):
        out = (out << 2) | ((comp >> (2 * j)) & 3)
    return out


# ---------------------------------------------------------------------------
# Host-side (numpy / Python int) helpers, used for decoding results to
# strings and in tests.  Not on any hot path.
# ---------------------------------------------------------------------------


def encode_str(s: str) -> np.ndarray:
    """String -> uint8 code array (host)."""
    return _ASCII_TO_CODE[np.frombuffer(s.encode(), dtype=np.uint8)]


def encode_str_parity(s: str) -> np.ndarray:
    """String -> codes with the reference-exact table (only uppercase TGCA
    are real bases, every other byte is 3)."""
    return _ASCII_TO_CODE_REF[np.frombuffer(s.encode("latin-1"), dtype=np.uint8)]


def decode_str(codes: np.ndarray) -> str:
    """uint8 code array -> string (host)."""
    return _CODE_TO_ASCII[np.asarray(codes, dtype=np.int64)].tobytes().decode()


def score_str(s: str) -> int:
    """Base-4 MSB-first score of a string under the reference-exact table."""
    score = 0
    for ch in s:
        score = score * 4 + int(_ASCII_TO_CODE_REF[ord(ch) & 0xFF])
    return score


def pack_str(s: str) -> int:
    """Packed integer of a string; identical to score_str by construction."""
    return score_str(s)


def unpack_int(value: int, n: int) -> str:
    """Packed integer -> length-n string (MSB-first)."""
    out = []
    for j in range(n - 1, -1, -1):
        out.append(BASE_BY_CODE[(value >> (2 * j)) & 3])
    return "".join(out)


def split_to_int(hi: int, lo: int, k: int) -> int:
    """(hi, lo) uint32 lanes of the JAX package -> single packed int."""
    n_lo = min(k, 16)
    return (int(hi) << (2 * n_lo)) | int(lo)


def int_to_split(value: int, k: int) -> tuple[int, int]:
    """Single packed int -> (hi, lo) uint32 lanes of the JAX package."""
    n_lo = min(k, 16)
    return value >> (2 * n_lo), value & ((1 << (2 * n_lo)) - 1)

"""Keys-only bitonic sorts of int64 keys: row sort, chunked full sort, hybrid.

Counterpart of the JAX package's ``ops/sort_pallas.py`` (``sort_rows``) and
``ops/bitonic_pallas.py`` (the three passes, ``sort_keys`` = ``sort_pairs``,
``sort_keys_hybrid`` = ``sort_pairs_hybrid``).  A key is ONE int64, so there
is no two-lane compare, no sign flip and no ``[rows, width]`` layout: the
array is flat and a chunk is a run of ``chunk`` consecutive keys.

The network.  A stage ``(d, size)`` compare-exchanges every pair
``(i, i + d)`` with ``(i & d) == 0``; the pair ends ascending iff
``(i & size) == 0``.  Merge level ``size`` is the stages ``d = size/2 .. 1``;
the levels ``2, 4, .. total`` sort ``total`` keys.  The stages with
``d < chunk`` stay inside one chunk (``chunk_sort`` for the levels up to the
chunk, ``finish`` for one larger level); a stage with ``d >= chunk`` is one
``big_ce`` pass over the whole array.  Equal keys are indistinguishable, so
every pass is a fixed function of its input.

Every pass has two forms.  The ``*_plain`` functions walk the network stage
by stage in tensor ops on whatever device the keys are on.  The dispatchers
(``sort_rows``, ``chunk_sort``, ``big_ce``, ``finish``) send a CUDA tensor to
the hand-written kernel (ops/bitonic_cuda.py, csrc/bitonic.cu) or raise, and
a CPU tensor to the plain form; there is no other route and no fallback
between the two.  On the card ``sort_rows`` and ``chunk_sort`` are block merge
sorts and no network: keys are values only, so a sort of every run gives the
network's bits for the levels ``2, 4 .. s`` that ``sort_keys`` sends
(``prefix_top``); any other list of levels ``chunk_sort`` takes on the CPU
only and refuses on the card.  With ``overwrite=True`` the caller gives its tensor up:
the kernel then works in place, the plain form returns a new tensor.
"""

from __future__ import annotations

from typing import Sequence

import torch

from genome_assembly_tpu_torch.common import SENTINEL

# Defaults of ``sort_keys`` / ``sort_keys_hybrid``, read at call time.
# chunk: keys one thread block sorts in shared memory (2^14 int64 = 128 KB,
# the most a block of the card holds).  Halving it makes ``finish`` faster
# but adds one ``big_ce`` stage to every level; on the hybrid sort of 231 M
# keys 2^14 came out 0.7 % ahead of 2^13 and 6 % ahead of 2^12 (H100 80GB
# HBM3 at 700 W, ``chunk_choice`` phase of chip_smoke.py).  lib_chunk: keys
# per library sort in the hybrid, the JAX package's ``xla_chunk``.
DEFAULT_CHUNK = 1 << 14
DEFAULT_LIB_CHUNK = 1 << 21


def _is_pow2(x: int) -> bool:
    return x >= 1 and x & (x - 1) == 0


def check_rows(key: torch.Tensor) -> None:
    """What ``sort_rows`` takes: [rows, C] int64, rows >= 1, C a power of two >= 2."""
    if key.dtype != torch.int64:
        raise TypeError(f"keys must be int64, got {key.dtype}")
    if key.dim() != 2 or key.shape[0] < 1:
        raise ValueError(f"sort_rows needs keys [rows >= 1, C], got {tuple(key.shape)}")
    if key.shape[1] < 2 or not _is_pow2(key.shape[1]):
        raise ValueError(f"row length {key.shape[1]} must be a power of two >= 2")


def check_chunked(key: torch.Tensor, chunk: int) -> None:
    """What the chunk passes take: flat int64 keys, a whole number of
    chunks, the chunk a power of two >= 2."""
    if key.dtype != torch.int64:
        raise TypeError(f"keys must be int64, got {key.dtype}")
    if chunk < 2 or not _is_pow2(chunk):
        raise ValueError(f"chunk {chunk} must be a power of two >= 2")
    if key.dim() != 1 or key.shape[0] < 1 or key.shape[0] % chunk:
        raise ValueError(
            f"need flat keys, a whole number of chunks of {chunk}; got {tuple(key.shape)}"
        )


def check_sizes(sizes: Sequence[int]) -> int:
    """Merge levels of a chunk pass: powers of two >= 2, strictly ascending.
    Returns them as a bit mask (bit b <=> level 2^b)."""
    mask, last = 0, 1
    for size in sizes:
        if size <= last or not _is_pow2(size) or size >= 1 << 63:
            raise ValueError(
                f"merge sizes must be strictly ascending powers of two >= 2, got {list(sizes)}"
            )
        mask |= size
        last = size
    return mask


def prefix_top(sizes: Sequence[int], chunk: int) -> int:
    """``s`` where ``sizes`` is the complete prefix ``2, 4 .. s`` of the
    network's levels with ``s <= chunk``, else 0.  Such a list sorts any
    input: it leaves every run of ``s`` consecutive keys sorted, the run that
    starts at global position ``p`` ascending iff ``(p & s) == 0``, else
    descending.  Any other list is a partial network and no sort."""
    sizes = list(sizes)
    if sizes and sizes == [2 << b for b in range(len(sizes))] and sizes[-1] <= chunk:
        return sizes[-1]
    return 0


def check_prefix(sizes: Sequence[int], chunk: int) -> int:
    """What ``chunk_sort`` takes on the card: the complete prefix ``2, 4 .. s``
    with ``s <= chunk``.  Returns ``s``."""
    top = prefix_top(sizes, chunk)
    if not top:
        raise ValueError(
            f"on the card chunk_sort takes the levels 2, 4 .. s with s <= chunk {chunk}, "
            f"got {list(sizes)}: a partial network is no sort")
    return top


def check_stage(key: torch.Tensor, d: int, size: int) -> None:
    """What ``big_ce`` takes: flat int64 keys, d and size powers of two,
    size >= 2 d, whole blocks of 2 d keys."""
    if key.dtype != torch.int64:
        raise TypeError(f"keys must be int64, got {key.dtype}")
    if not (_is_pow2(d) and _is_pow2(size) and 2 * d <= size < 1 << 63):
        raise ValueError(f"need powers of two with size >= 2 d; got d={d} size={size}")
    if key.dim() != 1 or key.shape[0] < 1 or key.shape[0] % (2 * d):
        raise ValueError(
            f"need flat keys, a whole number of blocks of {2 * d}; got {tuple(key.shape)}"
        )


def check_level(chunk: int, size: int) -> None:
    """What ``finish`` takes beside chunked keys: the level a power of two,
    at least one chunk."""
    if not _is_pow2(size) or not chunk <= size < 1 << 63:
        raise ValueError(f"size {size} must be a power of two >= chunk {chunk}")


# --------------------------------------------------------------------------
# plain versions: the network stage by stage, in tensor ops
# --------------------------------------------------------------------------

def _stage_plain(key: torch.Tensor, d: int, size: int, period: int = 0) -> torch.Tensor:
    """One stage on flat keys.  Blocks of 2 d keys are ``[lower half, upper
    half]``; a block is ascending iff its start has the ``size`` bit clear
    (size >= 2 d, so the whole block shares that bit).  ``period``: take
    positions within rows of that length instead of globally."""
    n = key.shape[0]
    v = key.reshape(n // (2 * d), 2, d)
    small = torch.minimum(v[:, 0], v[:, 1])
    large = torch.maximum(v[:, 0], v[:, 1])
    start = torch.arange(0, n, 2 * d, device=key.device)
    if period:
        start = start % period
    up = ((start & size) == 0)[:, None]
    out = torch.stack((torch.where(up, small, large), torch.where(up, large, small)), dim=1)
    return out.reshape(n)


def sort_rows_plain(key: torch.Tensor) -> torch.Tensor:
    """Every row of [rows, C] ascending: the full network, positions taken
    within the row."""
    check_rows(key)
    rows, c = key.shape
    flat = key.reshape(rows * c)
    size = 2
    while size <= c:
        d = size // 2
        while d >= 1:
            flat = _stage_plain(flat, d, size, period=c)
            d //= 2
        size *= 2
    return flat.reshape(rows, c)


def chunk_sort_plain(key: torch.Tensor, sizes: Sequence[int], *, chunk: int) -> torch.Tensor:
    """For each merge level of ``sizes``, the stages with distance < chunk."""
    check_chunked(key, chunk)
    check_sizes(sizes)
    for size in sizes:
        d = min(size // 2, chunk // 2)
        while d >= 1:
            key = _stage_plain(key, d, size)
            d //= 2
    return key


def big_ce_plain(key: torch.Tensor, d: int, size: int) -> torch.Tensor:
    """One compare-exchange stage at distance d of merge level size."""
    check_stage(key, d, size)
    return _stage_plain(key, d, size)


def finish_plain(key: torch.Tensor, size: int, *, chunk: int) -> torch.Tensor:
    """The stages chunk/2 .. 1 of merge level size."""
    check_chunked(key, chunk)
    check_level(chunk, size)
    d = chunk // 2
    while d >= 1:
        key = _stage_plain(key, d, size)
        d //= 2
    return key


# --------------------------------------------------------------------------
# dispatchers: CUDA tensor -> kernel, CPU tensor -> plain version
# --------------------------------------------------------------------------

def sort_rows(key: torch.Tensor) -> torch.Tensor:
    """Sort every row of [rows, C] int64 keys ascending (C a power of two)."""
    if key.is_cuda:
        from genome_assembly_tpu_torch.ops import bitonic_cuda

        return bitonic_cuda.sort_rows_cuda(key)
    return sort_rows_plain(key)


def chunk_sort(key: torch.Tensor, sizes: Sequence[int], *, chunk: int,
               overwrite: bool = False) -> torch.Tensor:
    if key.is_cuda:
        from genome_assembly_tpu_torch.ops import bitonic_cuda

        return bitonic_cuda.chunk_sort_cuda(key, sizes, chunk=chunk, overwrite=overwrite)
    return chunk_sort_plain(key, sizes, chunk=chunk)


def big_ce(key: torch.Tensor, d: int, size: int, *, overwrite: bool = False) -> torch.Tensor:
    if key.is_cuda:
        from genome_assembly_tpu_torch.ops import bitonic_cuda

        return bitonic_cuda.big_ce_cuda(key, d, size, overwrite=overwrite)
    return big_ce_plain(key, d, size)


def finish(key: torch.Tensor, size: int, *, chunk: int,
           overwrite: bool = False) -> torch.Tensor:
    if key.is_cuda:
        from genome_assembly_tpu_torch.ops import bitonic_cuda

        return bitonic_cuda.finish_cuda(key, size, chunk=chunk, overwrite=overwrite)
    return finish_plain(key, size, chunk=chunk)


# --------------------------------------------------------------------------
# the two sorts
# --------------------------------------------------------------------------

def _padded_copy(key: torch.Tensor, unit: int) -> torch.Tensor:
    """A copy of flat ``key`` padded with SENTINEL to ``unit * 2^j`` keys;
    the sort owns it and may overwrite it.  Sentinels sort last, so
    trimming the sorted copy back to n keeps the real keys."""
    n = key.shape[0]
    total = unit
    while total < n:
        total *= 2
    buf = key.new_full((total,), SENTINEL)
    buf[:n] = key
    return buf


def _merge_levels(buf: torch.Tensor, first_size: int, chunk: int) -> torch.Tensor:
    """Run the merge levels first_size, 2 first_size, .. total on a buffer
    the sort owns: per level the big stages, then one finish pass."""
    total = buf.shape[0]
    size = first_size
    while size <= total:
        d = size // 2
        while d >= chunk:
            buf = big_ce(buf, d, size, overwrite=True)
            d //= 2
        buf = finish(buf, size, chunk=chunk, overwrite=True)
        size *= 2
    return buf


def _check_flat_keys(key: torch.Tensor, **units: int) -> None:
    if key.dtype != torch.int64 or key.dim() != 1:
        raise TypeError(f"need flat int64 keys, got {key.dtype} {tuple(key.shape)}")
    for name, unit in units.items():
        if unit < 2 or not _is_pow2(unit):
            raise ValueError(f"{name} {unit} must be a power of two >= 2")


def sort_keys(key: torch.Tensor, *, chunk: int | None = None) -> torch.Tensor:
    """Ascending sort of flat int64 keys by the chunked bitonic network.

    Below two chunks the library sort, as the JAX ``sort_pairs``; else pad
    with SENTINEL to ``chunk * 2^j``, sort every chunk with one
    ``chunk_sort`` pass, then per larger level the ``big_ce`` stages and one
    ``finish`` pass, and trim.  Never writes into ``key``.
    """
    chunk = DEFAULT_CHUNK if chunk is None else chunk
    _check_flat_keys(key, chunk=chunk)
    n = key.shape[0]
    if n < 2 * chunk:
        return torch.sort(key).values
    buf = _padded_copy(key, chunk)
    sizes = [1 << b for b in range(1, chunk.bit_length())]  # 2 .. chunk
    buf = chunk_sort(buf, sizes, chunk=chunk, overwrite=True)
    return _merge_levels(buf, 2 * chunk, chunk)[:n]


def sort_keys_hybrid(key: torch.Tensor, *, lib_chunk: int | None = None,
                     chunk: int | None = None) -> torch.Tensor:
    """Large-n sort: library sorts of ``lib_chunk`` keys, bitonic merges.

    At or below two library chunks one library sort, as the JAX
    ``sort_pairs_hybrid``; else pad to ``lib_chunk * 2^j``, sort every
    library chunk with ``torch.sort`` along rows (the sort the JAX package
    also leaves to the library, outside any kernel), reverse the odd
    chunks -- the array is then in the network's state after level
    ``lib_chunk`` -- and run the remaining levels with ``big_ce`` and
    ``finish``.  Never writes into ``key``.
    """
    lib_chunk = DEFAULT_LIB_CHUNK if lib_chunk is None else lib_chunk
    chunk = DEFAULT_CHUNK if chunk is None else chunk
    _check_flat_keys(key, lib_chunk=lib_chunk, chunk=chunk)
    if lib_chunk % chunk:
        raise ValueError(f"lib_chunk {lib_chunk} must be a multiple of the chunk {chunk}")
    n = key.shape[0]
    if n <= 2 * lib_chunk:
        return torch.sort(key).values
    buf = _padded_copy(key, lib_chunk)
    # .values alone is kept: the indices are freed before the merge levels
    rows = torch.sort(buf.view(-1, lib_chunk), dim=1).values
    del buf
    rows[1::2] = rows[1::2].flip(1)
    return _merge_levels(rows.view(-1), 2 * lib_chunk, chunk)[:n]

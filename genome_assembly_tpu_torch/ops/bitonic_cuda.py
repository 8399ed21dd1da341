"""Wrappers of the kernels of csrc/bitonic.cu, launched by the torch
operators ``ga_torch::sort_rows``, ``chunk_sort``, ``big_ce`` and ``finish``
(csrc/bitonic_op.cpp).

Replace the JAX package's ``sort_rows_pallas`` (ops/sort_pallas.py) and
``_run_chunk_pass``, ``_run_big_ce``, ``_run_finish`` (ops/bitonic_pallas.py).
Each wrapper checks what its kernel does not take and raises, and allocates
only its output; the operator launches on torch's current stream of the
keys' card and does not synchronise.
A wrapper writes into its caller's tensor only when told ``overwrite=True``
(the sorts say so for the buffer they own).  ``launch_count[name]`` goes up
by one per launch of that kernel and nowhere else, so a run can show which
kernels it went through.

``finish_cuda`` takes its block's shape from ``finish_shape``.
``chunk_sort_cuda`` takes the merge levels ``2, 4 .. s`` with ``s <= chunk``
(``bitonic_sort.prefix_top``), which sort every run of ``s`` keys: one launch
of the block merge sort.  Any other list is a partial network and no sort; no
sort sends one and the wrapper refuses it.

The operator library is built and loaded at the first launch, never at
import; a CPU tensor is refused before anything is built.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from genome_assembly_tpu_torch.ops import bitonic_sort

# launches of each kernel since import (or since a caller reset them)
launch_count = {"sort_rows": 0, "chunk_sort": 0, "big_ce": 0, "finish": 0}

# Keys one thread of ``finish`` holds (a chunk shorter than that is one
# thread's).  It runs log2 of it stages in registers between two trips
# through shared memory; the block has chunk / FINISH_KEYS_PER_THREAD threads
# (``finish_shape``).  ``finish`` over 2^28 keys at level 2^28, ms by keys a
# thread 8 / 16 / 32 (H100 80GB HBM3 at 700 W, chip_smoke.py chunk_choice,
# there and back): chunk 2^14 - / 2.06, 2.06 / 2.07, 2.03 (32: two exchanges
# instead of three, 109 registers); 2^13 2.08, 2.03 / 1.82, 1.85 / 1.72,
# 1.70; 2^12 1.74, 1.73 / 1.65, 1.64 / 1.65, 1.65.
FINISH_KEYS_PER_THREAD = 32

# Keys one block holds in shared memory (``bitonic_max_shared_keys()`` of
# the library): the largest row of ``sort_rows`` and the largest chunk.
MAX_SHARED_KEYS = 1 << 14

# The two merge sorts (``sort_rows``, ``chunk_sort``).  KEYS_PER_THREAD: keys
# one thread owns, as the kernels are compiled.  BLOCK_KEYS: keys one thread
# block takes at least (a block takes whole runs, so a longer run takes a
# larger block).  Measured on 2^26 keys as rows of C (NVIDIA H100 80GB HBM3 at
# 700 W, ``rows_choice`` phase of chip_smoke.py), ms: C = 4096 in blocks of
# 4096 keys 1.25, of 2^14 1.39: 34 KB a block leave room for several blocks an
# SM, whose loads and stores overlap the others' merge rounds; C = 1024 in
# blocks of 1024 1.00, of 2048 0.99, of 4096 0.98, of 2^14 1.13; C = 64 in
# blocks of one row (4 threads) 3.98, of 2048 0.49, of 4096 0.50, of 2^14 0.63.
KEYS_PER_THREAD = 16
BLOCK_KEYS = 1 << 12


def block_shape(run: int) -> Tuple[int, int, int]:
    """(block_keys, threads, shared bytes) of a thread block of the merge
    sorts for runs of ``run`` keys (a row of ``sort_rows``, the last level of
    ``chunk_sort``): a power of two of keys that is a multiple of the run,
    ``KEYS_PER_THREAD`` keys a thread, held in shared memory with one key of
    room after every 16."""
    block_keys = max(run, BLOCK_KEYS, KEYS_PER_THREAD)
    shared_bytes = (block_keys + block_keys // 16 + 1) * 8
    return block_keys, block_keys // KEYS_PER_THREAD, shared_bytes


def finish_shape(chunk: int) -> Tuple[int, int, Tuple[Tuple[int, ...], ...], int]:
    """(threads, keys a thread, groups of stage bits, shared bytes) of a
    ``finish`` block for chunks of ``chunk`` keys (a power of two from 2 to
    ``MAX_SHARED_KEYS``).  The stage of distance 2^b is named by its bit b.
    The groups run from the top bit down, log2(keys a thread) bits each, the
    last one the bits left at the bottom; the keys cross shared memory once
    between two groups, in block_sort.cuh's skewed layout (room for one key
    after every 16), and not at all where one group holds every stage."""
    per_thread = min(FINISH_KEYS_PER_THREAD, chunk)
    g = per_thread.bit_length() - 1
    bits = list(range(chunk.bit_length() - 2, -1, -1))  # log2(chunk) - 1 .. 0
    groups = tuple(tuple(bits[i:i + g]) for i in range(0, len(bits), g))
    shared_bytes = (chunk + chunk // 16 + 1) * 8 if len(groups) > 1 else 0
    return chunk // per_thread, per_thread, groups, shared_bytes


# torch.ops.ga_torch once the operator library is loaded
_ops = None


def _load():
    global _ops
    if _ops is None:
        from genome_assembly_tpu_torch.csrc import build

        build.load_operators("bitonic")
        if torch.ops.ga_torch.bitonic_max_shared_keys() != MAX_SHARED_KEYS:
            raise RuntimeError("bitonic.cu and bitonic_cuda.py disagree on the largest chunk")
        _ops = torch.ops.ga_torch
    return _ops


def _check_on_card(name: str, key: torch.Tensor) -> None:
    if not key.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor")
    if not key.is_contiguous():
        raise ValueError(f"{name} needs a contiguous tensor")


def _check_fits(name: str, keys: int) -> None:
    if keys > MAX_SHARED_KEYS:
        raise ValueError(
            f"{name}: {keys} keys do not fit a block's shared memory "
            f"(at most {MAX_SHARED_KEYS})"
        )


def _launch(name: str, key: torch.Tensor, overwrite: bool, *ints: int) -> torch.Tensor:
    """Launch kernel ``name`` on ``key`` (its output ``key`` itself or a new
    tensor) with the launcher's ints; count it."""
    op = getattr(_load(), name)
    out = key if overwrite else torch.empty_like(key)
    op(key, out, *ints)
    launch_count[name] += 1
    return out


def sort_rows_cuda(key: torch.Tensor) -> torch.Tensor:
    """Every row of contiguous CUDA keys [rows, C] sorted ascending; C a
    power of two from 2 to ``MAX_SHARED_KEYS``, any rows >= 1."""
    _check_on_card("sort_rows_cuda", key)
    bitonic_sort.check_rows(key)
    rows, c = key.shape
    _check_fits("sort_rows_cuda", c)
    block_keys = block_shape(c)[0]
    return _launch("sort_rows", key, False, rows, c, block_keys)


def chunk_sort_cuda(key: torch.Tensor, sizes: Sequence[int], *, chunk: int,
                    overwrite: bool = False) -> torch.Tensor:
    """The merge levels ``sizes == [2, 4 .. s]``, ``s <= chunk``, of the network
    on flat contiguous CUDA keys of a whole number of chunks: every run of
    ``s`` keys sorted, ascending iff its global start has the ``s`` bit clear.
    One launch of the block merge sort; any other list is refused."""
    _check_on_card("chunk_sort_cuda", key)
    bitonic_sort.check_chunked(key, chunk)
    bitonic_sort.check_sizes(sizes)
    _check_fits("chunk_sort_cuda", chunk)
    n = key.shape[0]
    top = bitonic_sort.check_prefix(sizes, chunk)
    block_keys = block_shape(top)[0]
    return _launch("chunk_sort", key, overwrite, n, top, block_keys)


def big_ce_cuda(key: torch.Tensor, d: int, size: int, *,
                overwrite: bool = False) -> torch.Tensor:
    """One compare-exchange stage at distance d of merge level size, on flat
    contiguous CUDA keys of a whole number of blocks of 2 d."""
    _check_on_card("big_ce_cuda", key)
    bitonic_sort.check_stage(key, d, size)
    n = key.shape[0]
    return _launch("big_ce", key, overwrite, n, d, size)


def finish_cuda(key: torch.Tensor, size: int, *, chunk: int,
                overwrite: bool = False) -> torch.Tensor:
    """The stages chunk/2 .. 1 of merge level size, on flat contiguous CUDA
    keys of a whole number of chunks; a block of ``finish_shape(chunk)``."""
    _check_on_card("finish_cuda", key)
    bitonic_sort.check_chunked(key, chunk)
    bitonic_sort.check_level(chunk, size)
    _check_fits("finish_cuda", chunk)
    n_chunks = key.shape[0] // chunk
    per_thread = finish_shape(chunk)[1]
    return _launch("finish", key, overwrite, n_chunks, chunk, size, per_thread)

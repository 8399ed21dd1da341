"""Wrappers of the merge-path kernels (csrc/mergepath.cu), launched by the
torch operators ``ga_torch::local_merge``, ``merge_pass`` and
``merge_splits`` (csrc/mergepath_op.cpp).

Replace the JAX package's ``_local_merge_pass``, ``_merge_pass`` and
``merge_splits`` (ops/mergepath_pallas.py).  Each wrapper checks what its
kernel does not take and raises, and allocates only its output; the
operator launches on torch's current stream of the keys' card and does not
synchronise.  ``local_merge_cuda`` writes into its caller's tensor only when
told ``overwrite=True``; ``merge_pass_cuda`` never works in place (a tile
reads from anywhere in its run pair) and writes into ``out`` where the
caller gives one.  ``launch_count[name]`` goes up by one per launch of that
kernel and nowhere else, so a run can show which kernels it went through.

The operator library is built and loaded at the first launch, never at
import; a CPU tensor is refused before anything is built.
"""

from __future__ import annotations

from typing import Sequence

import torch

from genome_assembly_tpu_torch.ops import mergepath_sort

# launches of each kernel since import (or since a caller reset them)
launch_count = {"local_merge": 0, "merge_pass": 0, "merge_splits": 0}

# Outputs one ``merge_pass`` thread merges: 4, 8 or 16 (a block has tile /
# KEYS_PER_THREAD threads; the wrapper takes fewer for a tile that has fewer
# keys, and more where the block would need more than 1024 threads).
# Measured on 2^28 keys, one pass at run 2^27 (NVIDIA H100 80GB HBM3 at 700 W,
# one run of the ``tile_choice`` phase of chip_smoke.py): 4, 8 and 16 keys a
# thread take 1.50, 1.55 and 1.99 ms at tile 2^10, 1.57, 1.69 and 2.06 at
# 2^11, 1.86, 1.77 and 2.27 at 2^12, and 2.14 (8) and 2.65 (16) at 2^13.
KEYS_PER_THREAD = 4

# Keys one ``local_merge`` thread owns: 16 or 32 for a full chunk of 2^14 (a
# block has chunk / LOCAL_KEYS_PER_THREAD threads, at most 1024; the wrapper
# adapts it as above).  Same run: a chunk sort from single keys takes 6.41 and
# 6.44 ms with 16 keys a thread (1024 threads, 62 registers, no spills) and
# 6.38 with 32 (512 threads); at chunk 2^13, 6.59, 5.42 and 5.50 ms with 8, 16
# and 32.  A tie at the full chunk; 16 is kept.
LOCAL_KEYS_PER_THREAD = 16

# Keys one block holds in shared memory (what the library says of itself):
# the largest chunk of ``local_merge``, the largest tile of ``merge_pass``.
MAX_CHUNK_KEYS = 1 << 14
MAX_TILE_KEYS = 1 << 13

# torch.ops.ga_torch once the operator library is loaded
_ops = None


def _load():
    global _ops
    if _ops is None:
        from genome_assembly_tpu_torch.csrc import build

        build.load_operators("mergepath")
        ops = torch.ops.ga_torch
        if (ops.mergepath_max_chunk_keys(), ops.mergepath_max_tile_keys()) != (
                MAX_CHUNK_KEYS, MAX_TILE_KEYS):
            raise RuntimeError("mergepath.cu and mergepath_cuda.py disagree on their limits")
        _ops = ops
    return _ops


def _check_on_card(name: str, what: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} needs {what} as a CUDA tensor")
    if not t.is_contiguous():
        raise ValueError(f"{name} needs {what} contiguous")


def _keys_per_thread(wanted: int, keys: int) -> int:
    """Keys a thread of a block that holds ``keys`` keys: ``wanted``, fewer
    for a block of fewer keys, more where that needs over 1024 threads."""
    per_thread = min(wanted, keys)
    while keys // per_thread > 1024:
        per_thread *= 2
    return per_thread


def local_merge_cuda(key: torch.Tensor, levels: Sequence[int], *, chunk: int,
                     overwrite: bool = False) -> torch.Tensor:
    """The merge levels ``levels`` (consecutive powers of two, 2 .. chunk)
    inside every chunk of flat contiguous CUDA keys of a whole number of
    chunks, whose runs of ``levels[0] / 2`` keys ascend; chunk a power of two
    from 2 to ``MAX_CHUNK_KEYS``."""
    _check_on_card("local_merge_cuda", "its keys", key)
    mergepath_sort.check_chunked(key, chunk)
    mergepath_sort.check_levels(levels, chunk)
    if chunk > MAX_CHUNK_KEYS:
        raise ValueError(
            f"local_merge_cuda: a chunk of {chunk} keys does not fit a block's shared "
            f"memory (at most {MAX_CHUNK_KEYS})")
    n_chunks = key.shape[0] // chunk
    per_thread = _keys_per_thread(LOCAL_KEYS_PER_THREAD, chunk)
    ops = _load()
    out = key if overwrite else torch.empty_like(key)
    ops.local_merge(key, out, n_chunks, chunk, levels[0] // 2, levels[-1], per_thread)
    launch_count["local_merge"] += 1
    return out


def merge_pass_cuda(key: torch.Tensor, a0: torch.Tensor, b0: torch.Tensor, *, run: int,
                    tile: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """One merge level ``run -> 2 run`` of flat contiguous CUDA keys (a whole
    number of run pairs, runs ascending): output tile i is the merge of
    ``key[a0[i] : a0[i + 1])`` and ``key[b0[i] : b0[i + 1])``, the last tile of a
    run pair taking both runs to their ends
    (``mergepath_sort.tile_segments``).  a0, b0: int64 ``[n / tile]`` on the
    keys' device, as ``merge_splits`` gives them.  tile a power of two from 2
    to ``MAX_TILE_KEYS``."""
    _check_on_card("merge_pass_cuda", "its keys", key)
    mergepath_sort.check_merge(key, run, tile)
    if tile > MAX_TILE_KEYS:
        raise ValueError(
            f"merge_pass_cuda: a tile of {tile} keys is more than a block takes "
            f"(at most {MAX_TILE_KEYS})")
    n_tiles = key.shape[0] // tile
    for what, split in (("a0", a0), ("b0", b0)):
        _check_on_card("merge_pass_cuda", what, split)
        if split.dtype != torch.int64 or tuple(split.shape) != (n_tiles,):
            raise TypeError(
                f"{what} must be int64 [{n_tiles}], got {split.dtype} {tuple(split.shape)}")
        if split.device != key.device:
            raise ValueError(f"{what} lies on {split.device}, the keys on {key.device}")
    if out is not None:
        _check_on_card("merge_pass_cuda", "out", out)
        mergepath_sort.check_out(key, out)
    per_thread = _keys_per_thread(KEYS_PER_THREAD, tile)
    ops = _load()
    if out is None:
        out = torch.empty_like(key)
    ops.merge_pass(key, out, a0, b0, n_tiles, tile, run, per_thread)
    launch_count["merge_pass"] += 1
    return out


def merge_splits_cuda(key: torch.Tensor, run: int, tile: int) -> mergepath_sort.Splits:
    """``merge_splits`` of flat contiguous CUDA keys (a whole number of run
    pairs, runs ascending): int64 ``[n / tile]`` tensors ``(a0, b0, aend,
    bend)``, rows of one allocation, found by one thread a tile."""
    _check_on_card("merge_splits_cuda", "its keys", key)
    mergepath_sort.check_merge(key, run, tile)
    n_tiles = key.shape[0] // tile
    ops = _load()
    a0, b0, aend, bend = torch.empty((4, n_tiles), dtype=torch.int64,
                                     device=key.device).unbind(0)
    ops.merge_splits(key, a0, b0, aend, bend, n_tiles, tile, run)
    launch_count["merge_splits"] += 1
    return a0, b0, aend, bend

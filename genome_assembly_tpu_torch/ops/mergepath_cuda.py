"""ctypes bindings and wrappers of the merge-path kernels (csrc/mergepath.cu).

Replace the JAX package's ``_local_merge_pass`` and ``_merge_pass``
(ops/mergepath_pallas.py).  Each wrapper checks what its kernel does not take
and raises; it launches on torch's current stream, does not synchronise and
allocates only its output.  ``local_merge_cuda`` writes into its caller's
tensor only when told ``overwrite=True``; ``merge_pass_cuda`` never works in
place (a tile reads from anywhere in its run pair) and writes into ``out``
where the caller gives one.  ``launch_count[name]`` goes up by one per launch
of that kernel and nowhere else, so a run can show which kernels it went
through.

The library is built and loaded at the first launch, never at import.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from genome_assembly_tpu_torch.ops import mergepath_sort

# launches of each kernel since import (or since a caller reset them)
launch_count = {"local_merge": 0, "merge_pass": 0}

# Outputs one ``merge_pass`` thread merges: 4 or 8 (a block has tile /
# KEYS_PER_THREAD threads; the wrapper takes 2 for a tile of 2 keys and 8 where
# 4 would need more than 1024 threads).  A ``local_merge`` block has 1024
# threads, or one per pair of a smaller chunk; the launcher sets that.
# Measured on 2^28 keys, one pass at run 2^27 (NVIDIA H100 80GB HBM3 at 700 W,
# one run of the ``tile_choice`` phase of chip_smoke.py): 4 against 8 keys a
# thread takes 1.77 against 2.05 ms at tile 2^10, 1.97 against 2.24 at 2^11,
# 2.14 against 2.37 at 2^12, and 3.07 against 3.06 at 2^13, where 8 stands
# for 4 in both.
KEYS_PER_THREAD = 4

# Keys one block holds in shared memory (what the library says of itself):
# the largest chunk of ``local_merge``, the largest tile of ``merge_pass``.
MAX_CHUNK_KEYS = 1 << 14
MAX_TILE_KEYS = 1 << 13

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from genome_assembly_tpu_torch.csrc import build

        lib = build.load("mergepath")
        ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        i64, u64 = ctypes.c_longlong, ctypes.c_ulonglong
        lib.local_merge_launch.argtypes = [ptr, ptr, i64, i32, u32, ptr]
        lib.merge_pass_launch.argtypes = [ptr, ptr, ptr, ptr, i64, i32, u64, i32, ptr]
        limits = (lib.mergepath_max_chunk_keys, lib.mergepath_max_tile_keys)
        for fn in (lib.local_merge_launch, lib.merge_pass_launch, *limits):
            fn.restype = ctypes.c_int
        for fn in limits:
            fn.argtypes = []
        if tuple(fn() for fn in limits) != (MAX_CHUNK_KEYS, MAX_TILE_KEYS):
            raise RuntimeError("mergepath.cu and mergepath_cuda.py disagree on their limits")
        _lib = lib
    return _lib


def _check_on_card(name: str, what: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} needs {what} as a CUDA tensor")
    if not t.is_contiguous():
        raise ValueError(f"{name} needs {what} contiguous")


def local_merge_cuda(key: torch.Tensor, levels: Sequence[int], *, chunk: int,
                     overwrite: bool = False) -> torch.Tensor:
    """The odd-even merge levels ``levels`` (ascending powers of two, 2 ..
    chunk) inside every chunk of flat contiguous CUDA keys of a whole number
    of chunks; chunk a power of two from 2 to ``MAX_CHUNK_KEYS``."""
    _check_on_card("local_merge_cuda", "its keys", key)
    mergepath_sort.check_chunked(key, chunk)
    mask = mergepath_sort.check_levels(levels, chunk)
    if chunk > MAX_CHUNK_KEYS:
        raise ValueError(
            f"local_merge_cuda: a chunk of {chunk} keys does not fit a block's shared "
            f"memory (at most {MAX_CHUNK_KEYS})")
    n_chunks = key.shape[0] // chunk
    with torch.cuda.device(key.device):
        out = key if overwrite else torch.empty_like(key)
        err = _library().local_merge_launch(
            key.data_ptr(), out.data_ptr(), n_chunks, chunk, mask,
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"local_merge kernel launch failed: cudaError {err}")
        launch_count["local_merge"] += 1
    return out


def merge_pass_cuda(key: torch.Tensor, a0: torch.Tensor, b0: torch.Tensor, *, run: int,
                    tile: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """One merge level ``run -> 2 run`` of flat contiguous CUDA keys (a whole
    number of run pairs, runs ascending): output tile i is the first ``tile``
    keys of the merge of ``key[a0[i] : a0[i] + tile)`` and ``key[b0[i] : b0[i] +
    tile)``, each read as +inf at and past its run's end.  a0, b0: int64
    ``[n / tile]`` on the keys' device, as ``merge_splits`` gives them.  tile a
    power of two from 2 to ``MAX_TILE_KEYS``."""
    _check_on_card("merge_pass_cuda", "its keys", key)
    mergepath_sort.check_merge(key, run, tile)
    if tile > MAX_TILE_KEYS:
        raise ValueError(
            f"merge_pass_cuda: two windows of {tile} keys do not fit a block's shared "
            f"memory (at most {MAX_TILE_KEYS})")
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
    per_thread = min(KEYS_PER_THREAD, tile)
    while tile // per_thread > 1024:
        per_thread *= 2
    with torch.cuda.device(key.device):
        if out is None:
            out = torch.empty_like(key)
        err = _library().merge_pass_launch(
            key.data_ptr(), out.data_ptr(), a0.data_ptr(), b0.data_ptr(), n_tiles, tile, run,
            per_thread, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"merge_pass kernel launch failed: cudaError {err}")
        launch_count["merge_pass"] += 1
    return out

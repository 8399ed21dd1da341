"""Keys-only merge-path sort of int64 keys: one pass over the array per merge level.

Counterpart of the JAX package's ``ops/mergepath_pallas.py``: ``merge_splits``,
the two passes (``local_merge`` = ``_local_merge_pass``, ``merge_pass`` =
``_merge_pass``) and ``sort_keys_mergepath`` = ``sort_pairs_mergepath``.  A key
is ONE int64 (ops/bitonic_sort.py says why), the array is flat, and positions,
runs and splits are int64; there is no ``[rows, width]`` layout and there are
no pad rows.

The sort.  Rows of ``base_run`` keys are sorted by the library.
``local_merge`` then turns, inside every block of ``chunk`` keys, ascending
runs of ``base_run`` into one ascending run of ``chunk`` with the Batcher
odd-even merge levels ``2 base_run, 4 base_run .. chunk``, all in one pass.
From there every level ``run -> 2 run`` is one ``merge_splits`` (tensor ops: a
binary search on the merge diagonal for every output tile) and one
``merge_pass``: output tile ``i`` is the first ``tile`` keys of the merge of
``A[a0 : a0 + tile)`` and ``B[b0 : b0 + tile)``, each read as +inf at and past
its run's end.  A bitonic level needs ``log2(run / chunk) + 1`` passes over the
array (ops/bitonic_sort.py); a merge-path level needs one.

The odd-even merge network.  Level ``window = 2 m`` merges the two ascending
halves of every aligned window.  Its stage ``k == m`` pairs ``p`` with
``p + m`` where ``(p & m) == 0``; a stage ``k < m`` pairs ``p`` with ``p + k``
where ``(p & k) == k`` and ``(p & (window - 1)) + k < window``.  The lower
position keeps the smaller key: always ascending, no direction bit.  Equal
keys are indistinguishable, so every pass is a fixed function of its input.

Every pass has two forms, as in ops/bitonic_sort.py.  The ``*_plain`` functions
walk the network stage by stage in tensor ops and call no library sort.  The
dispatchers send a CUDA tensor to the hand-written kernel
(ops/mergepath_cuda.py, csrc/mergepath.cu) or raise, and a CPU tensor to the
plain form; there is no other route.  ``local_merge_plain`` is the network on
any input; the two forms of ``merge_pass`` agree where its contract holds
(runs ascending, splits inside their runs), which is all the sort sends it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from genome_assembly_tpu_torch.common import SENTINEL
from genome_assembly_tpu_torch.ops.bitonic_sort import (
    _is_pow2, _padded_copy, check_chunked, check_sizes)

# Defaults of ``sort_keys_mergepath``, read at call time.  tile: keys of one
# output tile of ``merge_pass`` (one thread block; both windows in shared
# memory, 17 bytes a tile key).  chunk: keys of one block of ``local_merge``
# (8 bytes a key in shared memory, at most 2^14); a chunk half as large is one
# more ``merge_splits`` and ``merge_pass`` over the array.  base_run: keys of
# one library row sort.  Measured on 2^28 keys (NVIDIA H100 80GB HBM3 at
# 700 W, one run of the ``tile_choice`` phase of chip_smoke.py): one
# ``merge_pass`` alone is faster the smaller the tile (1.77 ms at 2^10, 1.97 at
# 2^11, 2.14 at 2^12, 3.07 at 2^13), but ``merge_splits`` then searches for
# more tiles, and its small tensor ops are launched from the host, so the
# whole sort's time follows the host more than the tile: 231 M keys took, there
# and back, 100.6 and 77.5 ms at tile 2^12, 97.4 and 74.2 at 2^11, 95.7 and
# 89.1 at 2^10, 85.3 and 83.2 at 2^13.  No tile wins on the whole sort; 2^12 is
# the middle.  Chunk 2^14 against 2^13: ``local_merge`` 9.93 against 6.59 ms,
# but one split search and ``merge_pass`` fewer; the whole sort 79.7 and 77.6
# against 71.9 and 82.3 ms, a tie.  The larger chunk is kept for the pass it
# saves on the card.
DEFAULT_MERGE_TILE = 1 << 12
DEFAULT_BASE_RUN = 1 << 10
DEFAULT_MERGE_CHUNK = 1 << 14

Splits = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def check_merge(key: torch.Tensor, run: int, tile: int) -> None:
    """What one merge level takes: flat int64 keys, a whole number of run
    pairs, run and tile powers of two, a tile no longer than a run."""
    if key.dtype != torch.int64:
        raise TypeError(f"keys must be int64, got {key.dtype}")
    if not (_is_pow2(run) and _is_pow2(tile)) or tile < 2 or tile > run or run >= 1 << 62:
        raise ValueError(f"need powers of two with 2 <= tile <= run; got tile={tile} run={run}")
    if key.dim() != 1 or key.shape[0] < 1 or key.shape[0] % (2 * run):
        raise ValueError(
            f"need flat keys, a whole number of run pairs of {2 * run}; got {tuple(key.shape)}")


def check_out(key: torch.Tensor, out: torch.Tensor) -> None:
    """``out`` of a merge level: a contiguous tensor of the keys' shape, type
    and device whose memory nowhere overlaps theirs (a view of the keys'
    buffer at an offset is refused like the keys themselves)."""
    n_bytes = key.numel() * key.element_size()
    if (out.shape != key.shape or out.dtype != key.dtype or out.device != key.device
            or not out.is_contiguous() or abs(out.data_ptr() - key.data_ptr()) < n_bytes):
        raise ValueError("out must be a contiguous tensor of the keys' shape, type and device "
                         "that shares no memory with them")


def check_levels(levels: Sequence[int], chunk: int) -> int:
    """Merge levels of ``local_merge``: strictly ascending powers of two from
    2 to the chunk.  Returns them as a bit mask (bit b <=> level 2^b)."""
    mask = check_sizes(levels)
    if mask >= 2 * chunk:
        raise ValueError(f"merge levels {list(levels)} must not exceed the chunk {chunk}")
    return mask


def merge_splits(key: torch.Tensor, run: int, tile: int) -> Splits:
    """Per-output-tile source splits of one merge level.

    key: flat int64, ascending in runs of ``run``.  Returns int64 ``[n / tile]``
    tensors ``(a0, b0, aend, bend)``: tile i of the merged output consumes
    ``A[a0..]`` and ``B[b0..]`` of its run pair ``A | B``, which end at ``aend``
    and ``bend``.  The split is the merge-path crossing on the tile's diagonal
    ``d``: the largest ``j`` with ``A[j-1] <= B[d-j]`` (so equal keys of A go
    first), found for all tiles at once by a binary search of
    ``ceil(log2(run)) + 1`` steps.
    """
    check_merge(key, run, tile)
    n = key.shape[0]
    out0 = torch.arange(0, n, tile, dtype=torch.int64, device=key.device)
    base = out0 // (2 * run) * (2 * run)
    d = out0 - base
    # every step is a dozen small tensor ops over n / tile elements, so its
    # cost is the launches: the constants are taken out of the loop
    a_at = base - 1          # A[j-1] lies at a_at + j
    b_at = base + run + d    # B[d-j] lies at b_at - j
    j_inf = d - run          # d - j >= run  <=>  j <= j_inf

    def pred(j):
        # True iff split j is not past the crossing.  j == 0: A[-1] is -inf;
        # d - j >= run: B[run] is +inf.  Both gathers are clamped into the array.
        a = key[(a_at + j).clamp_(0, n - 1)]
        b = key[(b_at - j).clamp_(0, n - 1)]
        return (a <= b).logical_or_(j == 0).logical_or_(j <= j_inf)

    lo = j_inf.clamp(min=0)
    hi = d.clamp(max=run)
    for _ in range(max(1, (max(run, 2) - 1).bit_length() + 1)):
        mid = torch.add(lo, hi).add_(1).bitwise_right_shift_(1)
        ok = pred(mid)
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid.sub_(1))
    return base + lo, base + run + (d - lo), base + run, base + 2 * run


# --------------------------------------------------------------------------
# plain versions: the odd-even merge network stage by stage, in tensor ops
# --------------------------------------------------------------------------

def _merge_level_plain(key: torch.Tensor, m: int, window: int) -> torch.Tensor:
    """One merge level on flat keys of a whole number of windows (window ==
    2 m).  Returns a new tensor."""
    v = key.reshape(-1, 2, m)
    key = torch.stack((torch.minimum(v[:, 0], v[:, 1]), torch.maximum(v[:, 0], v[:, 1])), dim=1)
    k = m // 2
    while k >= 1:
        # a window is blocks of 2 k keys, [lower half, upper half]; the stage
        # pairs the upper half of every block but the window's last with the
        # lower half of the next block
        v = key.view(-1, window // (2 * k), 2, k)
        low, high = v[:, :-1, 1], v[:, 1:, 0]
        small, large = torch.minimum(low, high), torch.maximum(low, high)
        low.copy_(small)
        high.copy_(large)
        k //= 2
    return key.reshape(-1)


def local_merge_plain(key: torch.Tensor, levels: Sequence[int], *, chunk: int) -> torch.Tensor:
    """The merge levels ``levels`` (each at most the chunk) on every chunk."""
    check_chunked(key, chunk)
    check_levels(levels, chunk)
    for level in levels:
        key = _merge_level_plain(key, level // 2, level)
    return key


def _window(key: torch.Tensor, start: torch.Tensor, end: torch.Tensor, tile: int) -> torch.Tensor:
    """[n_tiles, tile]: key[start + i], SENTINEL at and past ``end``."""
    idx = start[:, None] + torch.arange(tile, dtype=torch.int64, device=key.device)
    return torch.where(idx < end[:, None], key[idx.clamp(max=key.shape[0] - 1)], SENTINEL)


def merge_pass_plain(key: torch.Tensor, splits: Splits, *, run: int, tile: int) -> torch.Tensor:
    """One merge level ``run -> 2 run``: per output tile the first ``tile`` keys
    of the merge of its two masked windows, by one level of the network."""
    check_merge(key, run, tile)
    a0, b0, aend, bend = splits
    both = torch.cat((_window(key, a0, aend, tile), _window(key, b0, bend, tile)), dim=1)
    merged = _merge_level_plain(both.reshape(-1), tile, 2 * tile)
    return merged.view(-1, 2 * tile)[:, :tile].reshape(-1)


# --------------------------------------------------------------------------
# dispatchers: CUDA tensor -> kernel, CPU tensor -> plain version
# --------------------------------------------------------------------------

def local_merge(key: torch.Tensor, levels: Sequence[int], *, chunk: int,
                overwrite: bool = False) -> torch.Tensor:
    if key.is_cuda:
        from genome_assembly_tpu_torch.ops import mergepath_cuda

        return mergepath_cuda.local_merge_cuda(key, levels, chunk=chunk, overwrite=overwrite)
    return local_merge_plain(key, levels, chunk=chunk)


def merge_pass(key: torch.Tensor, splits: Splits, *, run: int, tile: int,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """``out``: a tensor like ``key`` (never ``key`` itself: a tile reads from
    anywhere in its run pair) that takes the result; the plain form copies
    into it."""
    if key.is_cuda:
        from genome_assembly_tpu_torch.ops import mergepath_cuda

        return mergepath_cuda.merge_pass_cuda(key, splits[0], splits[1], run=run, tile=tile,
                                              out=out)
    merged = merge_pass_plain(key, splits, run=run, tile=tile)
    if out is None:
        return merged
    check_out(key, out)
    return out.copy_(merged)


# --------------------------------------------------------------------------
# the sort
# --------------------------------------------------------------------------

def sort_keys_mergepath(key: torch.Tensor, *, tile: int | None = None,
                        base_run: int | None = None,
                        chunk: int | None = None) -> torch.Tensor:
    """Ascending sort of flat int64 keys: library row sorts, one
    ``local_merge`` pass, one ``merge_pass`` per level above the chunk.

    Below four chunks the library sort, as the JAX ``sort_pairs_mergepath``;
    else pad with SENTINEL to a power of two, sort rows of ``base_run`` keys
    with ``torch.sort`` (the sort the JAX package also leaves to the library,
    outside any kernel), merge them up to the chunk (skipped when ``base_run
    == chunk``), then merge level by level between two buffers the sort owns,
    and trim.  Needs powers of two with ``tile <= chunk`` (a tile lies inside
    one run pair) and ``base_run <= chunk``.  Never writes into ``key``.
    """
    tile = DEFAULT_MERGE_TILE if tile is None else tile
    base_run = DEFAULT_BASE_RUN if base_run is None else base_run
    chunk = DEFAULT_MERGE_CHUNK if chunk is None else chunk
    if key.dtype != torch.int64 or key.dim() != 1:
        raise TypeError(f"need flat int64 keys, got {key.dtype} {tuple(key.shape)}")
    if not (_is_pow2(tile) and _is_pow2(base_run) and _is_pow2(chunk)) or tile < 2:
        raise ValueError(
            f"tile {tile} (>= 2), base_run {base_run} and chunk {chunk} must be powers of two")
    if tile > chunk or base_run > chunk:
        raise ValueError(
            f"tile {tile} and base_run {base_run} must not exceed the chunk {chunk}")
    n = key.shape[0]
    if n < 4 * chunk:
        return torch.sort(key).values
    spare = _padded_copy(key, chunk)
    total = spare.shape[0]
    # .values alone is kept; the padded copy becomes the second buffer
    buf = torch.sort(spare.view(-1, base_run), dim=1).values.view(-1)
    levels = [1 << b for b in range(base_run.bit_length(), chunk.bit_length())]
    if levels:
        buf = local_merge(buf, levels, chunk=chunk, overwrite=True)
    run = chunk
    while run < total:
        merged = merge_pass(buf, merge_splits(buf, run, tile), run=run, tile=tile, out=spare)
        buf, spare = merged, buf
        run *= 2
    return buf[:n]

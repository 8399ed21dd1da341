"""Keys-only merge-path sort of int64 keys: one pass over the array per merge level.

Counterpart of the JAX package's ``ops/mergepath_pallas.py``: ``merge_splits``,
the two passes (``local_merge`` = ``_local_merge_pass``, ``merge_pass`` =
``_merge_pass``) and ``sort_keys_mergepath`` = ``sort_pairs_mergepath``.  A key
is ONE int64 (ops/bitonic_sort.py says why), the array is flat, and positions,
runs and splits are int64; there is no ``[rows, width]`` layout and there are
no pad rows.

The sort.  ``local_merge`` turns, inside every block of ``chunk`` keys,
ascending runs of ``base_run`` into one ascending run of ``chunk`` by the merge
levels ``2 base_run, 4 base_run .. chunk``, all in one pass; with ``base_run ==
1`` that is a sort of every chunk, else rows of ``base_run`` keys are sorted by
the library first.  From there every level ``run -> 2 run`` is one
``merge_splits`` (a binary search on the merge diagonal for every output tile)
and one ``merge_pass``: output tile ``i`` is the merge of ``A[a0[i] : a0[i+1])``
and ``B[b0[i] : b0[i+1])`` (``tile_segments``).  A bitonic level needs
``log2(run / chunk) + 1`` passes over the array (ops/bitonic_sort.py); a
merge-path level needs one.

The odd-even merge network.  Level ``window = 2 m`` merges the two ascending
halves of every aligned window.  Its stage ``k == m`` pairs ``p`` with
``p + m`` where ``(p & m) == 0``; a stage ``k < m`` pairs ``p`` with ``p + k``
where ``(p & k) == k`` and ``(p & (window - 1)) + k < window``.  The lower
position keeps the smaller key: always ascending, no direction bit.  Equal
keys are indistinguishable, so every pass is a fixed function of its input.

Every pass has two forms, as in ops/bitonic_sort.py.  The ``*_plain`` functions
are tensor ops and call no library sort: the two passes walk the network stage
by stage, ``merge_splits_plain`` runs the binary search for all tiles at once.
The dispatchers send a CUDA tensor to the hand-written kernel
(ops/mergepath_cuda.py, csrc/mergepath.cu) or raise, and a CPU tensor to the
plain form; there is no other route.  The kernels merge with two heads where
the plain passes walk the network, so the two forms of ``local_merge`` and of
``merge_pass`` agree where the contract holds (runs ascending, splits inside
their runs), which is all the sort sends them; ``local_merge_plain`` is the
network on any input.  ``merge_splits`` has one answer on any input, and its
two forms give it bit for bit.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from genome_assembly_tpu_torch.common import SENTINEL
from genome_assembly_tpu_torch.ops.bitonic_sort import (
    _is_pow2, _padded_copy, check_chunked, check_sizes)

# Defaults of ``sort_keys_mergepath``, read at call time.  tile: keys of one
# output tile of ``merge_pass`` (one thread block, 8.5 bytes of shared memory a
# tile key).  chunk: keys of one block of ``local_merge`` (8.5 bytes a key, at
# most 2^14); a chunk half as large is one more ``merge_splits`` and
# ``merge_pass`` over the array.  base_run: keys of one library row sort; 1
# leaves the whole chunk sort to ``local_merge`` and calls no library sort.
# Measured on 2^28 keys (NVIDIA H100 80GB HBM3 at 700 W, one run of the
# ``tile_choice`` phase of chip_smoke.py).  base_run: ``local_merge`` takes
# 6.41 ms from single keys and 3.00 ms from rows of 2^10, which the library
# needs 17.29 ms to sort: 231 M keys sort in 31.7 and 31.7 ms with base_run 1
# against 45.5 and 45.5 with 2^10.  tile: one ``merge_pass`` with its
# ``merge_splits`` takes 1.50 + 0.39 ms at 2^10, 1.57 + 0.21 at 2^11, 1.86 +
# 0.14 at 2^12 (1.77 with 8 keys a thread) and 2.14 + 0.08 at 2^13: the pass
# is faster the smaller the tile, the search the larger.  The whole sort,
# there and back: 31.7 and 31.6 ms at 2^11, 32.5 and 32.5 at 2^10, 33.5 and
# 33.6 at 2^12 with 8 keys a thread (34.0 and 33.9 with 4), 38.0 and 38.0 at
# 2^13.  chunk 2^14 against 2^13: ``local_merge`` 6.41 against 5.42 ms, less
# than the level it saves; the whole sort 31.6 and 31.7 against 32.3 and 32.3.
DEFAULT_MERGE_TILE = 1 << 11
DEFAULT_BASE_RUN = 1
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


def check_levels(levels: Sequence[int], chunk: int) -> None:
    """Merge levels of ``local_merge``: at least one, consecutive powers of
    two (each twice the one before) from 2 to the chunk."""
    mask = check_sizes(levels)
    if not mask or mask >= 2 * chunk:
        raise ValueError(
            f"need merge levels from 2 to the chunk {chunk}, got {list(levels)}")
    if any(high != 2 * low for low, high in zip(levels, levels[1:])):
        raise ValueError(f"merge levels {list(levels)} must double from one to the next")


def merge_splits_plain(key: torch.Tensor, run: int, tile: int) -> Splits:
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


def tile_segments(splits: Splits, run: int, tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(a1, b1)``, int64 ``[n / tile]``: where tile i's two source segments
    end, as the ``merge_pass`` kernel derives it from ``a0, b0`` alone.  Tile
    i consumes ``A[a0[i] : a1[i])`` and ``B[b0[i] : b1[i])``: it ends where
    tile i + 1 of the same run pair begins, the pair's last tile at the runs'
    ends.  For splits of ascending runs the two lengths sum to ``tile``."""
    a0, b0, aend, bend = splits
    n_tiles = a0.shape[0]
    last = (torch.arange(1, n_tiles + 1, device=a0.device) % (2 * run // tile)) == 0
    a1 = torch.where(last, aend, torch.cat((a0[1:], aend[-1:])))
    b1 = torch.where(last, bend, torch.cat((b0[1:], bend[-1:])))
    return a1, b1


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

def merge_splits(key: torch.Tensor, run: int, tile: int) -> Splits:
    if key.is_cuda:
        from genome_assembly_tpu_torch.ops import mergepath_cuda

        return mergepath_cuda.merge_splits_cuda(key, run, tile)
    return merge_splits_plain(key, run, tile)


def local_merge(key: torch.Tensor, levels: Sequence[int], *, chunk: int,
                overwrite: bool = False) -> torch.Tensor:
    """``key``: runs of ``levels[0] / 2`` keys ascending (the kernel merges
    with two heads, which is the network only then)."""
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
    """Ascending sort of flat int64 keys: one ``local_merge`` pass (after
    library row sorts where ``base_run > 1``), then one ``merge_splits`` and one
    ``merge_pass`` per level above the chunk.

    Below four chunks the library sort, as the JAX ``sort_pairs_mergepath``;
    else pad with SENTINEL to a power of two, sort rows of ``base_run`` keys
    with ``torch.sort`` (the sort the JAX package also leaves to the library,
    outside any kernel; none for ``base_run == 1``), merge them up to the chunk
    (skipped when ``base_run == chunk``), then merge level by level between
    two buffers the sort owns, and trim.  Needs powers of two with ``tile <=
    chunk`` (a tile lies inside one run pair) and ``base_run <= chunk``.  Never
    writes into ``key``.
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
    # the padded copy becomes the second buffer of the merge levels
    levels = [1 << b for b in range(base_run.bit_length(), chunk.bit_length())]
    if base_run == 1:
        buf = local_merge(spare, levels, chunk=chunk)
    else:
        buf = torch.sort(spare.view(-1, base_run), dim=1).values.view(-1)
        if levels:
            buf = local_merge(buf, levels, chunk=chunk, overwrite=True)
    run = chunk
    while run < total:
        merged = merge_pass(buf, merge_splits(buf, run, tile), run=run, tile=tile, out=spare)
        buf, spare = merged, buf
        run *= 2
    return buf[:n]

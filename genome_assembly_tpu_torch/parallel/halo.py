"""Sequence parallelism: the k-1-base halo exchange for long sequences.

A sequence too long for one shard's rows (a contig, a whole genome) is cut
into equal segments, one a shard.  Each shard receives its right
neighbour's first k-1 bases (``ShardMesh.ppermute``, the ring shift to the
left) and scans its segment so extended: every window is scanned exactly
once, by the shard that holds its start.  The last shard's halo would be
shard 0's prefix, so its valid length is not extended.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def split_sequence(seq_codes: np.ndarray, n_shards: int, k: int):
    """One long code sequence -> ``n_shards`` equal segments (zero padded)
    and their valid lengths, ``[n_shards, ceil(total / n_shards)]`` uint8 and
    ``[n_shards]`` int32, for ``haloed_segments``."""
    total = len(seq_codes)
    seg_len = int(np.ceil(total / n_shards))
    segments = np.zeros((n_shards, seg_len), dtype=np.uint8)
    lens = np.zeros(n_shards, dtype=np.int32)
    for s in range(n_shards):
        lo = s * seg_len
        hi = min(total, lo + seg_len)
        if hi > lo:
            segments[s, :hi - lo] = seq_codes[lo:hi]
            lens[s] = hi - lo
    return segments, lens


def haloed_segments(segments, seg_lens, *, k: int, mesh
                    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """``[n_shards, L]`` segments -> the halo-extended ones.

    segments, seg_lens: the whole arrays (tensors or numpy; row ``s`` is
    shard ``s``'s, in the mesh's flat order).  Returns one ``[1, L + k - 1]``
    segment and one ``[1]`` valid length a local shard, on its device: the
    segment followed by the next shard's first k-1 bases; the lengths make
    each window counted once across the shards."""
    n = mesh.n_shards
    segs = mesh.shard_rows(segments)
    lens = mesh.shard_rows(seg_lens)
    # my first k-1 bases go to my left neighbour, extending its segment
    recv = mesh.ppermute([s[:, :k - 1] for s in segs], [(i, (i - 1) % n) for i in range(n)])
    ext = [torch.cat([s, r], dim=1) for s, r in zip(segs, recv)]
    ext_lens = [ln if g == n - 1 else ln + (k - 1) for g, ln in zip(mesh.local, lens)]
    return ext, ext_lens

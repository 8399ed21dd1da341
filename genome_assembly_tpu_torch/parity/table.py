"""Host-side materialization of the device-counted parity table.

Converts the padded, sorted ``CountedTable`` tensors into the structures
the replay engines and the printers consume.  Each lane is pulled off the
device once (its valid prefix: invalid rows sort last), with one copy a
lane; the per-group split runs in host numpy.  The arrays come back in
the JAX package's host dtypes (uint32 m-mers, stream indices and read
ids, int32 counts), so the replay engines see the same numbers; the
k-mer stays this package's one int64 key.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from genome_assembly_tpu_torch.ops import encode
from genome_assembly_tpu_torch.ops.count import CountedTable


class HostTable(NamedTuple):
    """Counted groups ready for replay, sorted by (mmer, kmer).

    Each group holds its occurrence read ids in stream (ascending) order.
    ``first_seen`` is the flat stream index of the group's first
    occurrence -- the replay sorts by it to recover the reference's
    insertion order.
    """

    mmer: np.ndarray  # [G] uint32
    kmer: np.ndarray  # [G] int64 packed k-mer key
    count: np.ndarray  # [G] int32
    first_seen: np.ndarray  # [G] uint32 stream index of first occurrence
    read_ids: List[np.ndarray]  # per group, uint32, stream order


def _pull(table: CountedTable, pruned: bool, with_streams: bool):
    n = int(table.valid.sum())
    lanes = {
        name: getattr(table, name)[:n].cpu().numpy()
        for name in ("mmer", "kmer", "read_id", "stream_idx", "group_start", "count", "keep")
    }
    starts = np.flatnonzero(lanes["group_start"])
    if pruned:
        starts = starts[lanes["keep"][starts]]
    sizes = lanes["count"][starts]
    stream = lanes["stream_idx"].astype(np.uint32)
    rid = lanes["read_id"].astype(np.uint32)
    host = HostTable(
        mmer=lanes["mmer"][starts].astype(np.uint32),
        kmer=lanes["kmer"][starts],
        count=sizes.astype(np.int32),
        first_seen=stream[starts],
        read_ids=[rid[s : s + c] for s, c in zip(starts.tolist(), sizes.tolist())],
    )
    if not with_streams:
        return host, None
    streams = [stream[s : s + c] for s, c in zip(starts.tolist(), sizes.tolist())]
    return host, streams


def extract_groups(table: CountedTable, *, pruned: bool = True) -> HostTable:
    """Pull surviving (or all valid) groups off the device."""
    return _pull(table, pruned, with_streams=False)[0]


def extract_groups_with_streams(
    table: CountedTable, *, pruned: bool = True
) -> Tuple[HostTable, List[np.ndarray]]:
    """extract_groups plus each group's per-occurrence stream indices.

    The stream lane rides the same stable sort as read ids, so
    streams[g][j] is the flat (read, window) position of read_ids[g][j] --
    what the non-ACGT exception path (parity/nonacgt.py) needs to map
    occurrences back to raw read bytes.
    """
    return _pull(table, pruned, with_streams=True)


def decode_table(
    host: HostTable, k: int, m: int
) -> Dict[Tuple[str, str], List[int]]:
    """String-keyed table: (mmer, kmer) -> read ids descending.

    Matches parity.model.count_table for differential tests.
    """
    out: Dict[Tuple[str, str], List[int]] = {}
    for i in range(len(host.mmer)):
        sig = encode.unpack_int(int(host.mmer[i]), m)
        kmer = encode.unpack_int(int(host.kmer[i]), k)
        out[(sig, kmer)] = list(map(int, host.read_ids[i][::-1]))
    return out

"""Read loading and batching, on the host in numpy.  ``batch_reads`` times
its two steps as spans of the run in progress (``utils/profiling.span``):
``encode`` and ``scatter`` of the ``batch`` phase.

Parity mode reproduces the reference driver's input handling exactly:
``fgets(read, READ_LENGTH=101, file)`` reads at most 100 characters per
call, and the driver then chops the final character of whatever it got
(assuming it was the newline).  So a 100-bp line becomes a 99-bp read
(its last base chopped) and an empty read (the newline left unread), each
consuming a read id of its own.  Fast mode reads one sequence per line.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence

import numpy as np

from genome_assembly_tpu_torch.ops import encode
from genome_assembly_tpu_torch.utils import profiling

_ACGT = frozenset("ACGT")


def fgets_chunks(data: bytes, buffer_size: int) -> Iterator[str]:
    """Yield the successive strings fgets(buf, buffer_size) would return.

    Each chunk is at most ``buffer_size - 1`` characters and ends either at a
    newline (inclusive) or at the character limit.
    """
    limit = buffer_size - 1
    pos = 0
    n = len(data)
    while pos < n:
        nl = data.find(b"\n", pos, pos + limit)
        end = nl + 1 if nl != -1 else min(pos + limit, n)
        yield data[pos:end].decode("latin-1")
        pos = end


def load_reads_parity(path: str, read_length: int = 101) -> List[str]:
    """Load reads the way the reference ``main`` does.

    Returns one string per consumed read id, including empty reads from
    leftover newlines; each chunk has its final character chopped.
    """
    with open(path, "rb") as f:
        data = f.read()
    return [chunk[:-1] for chunk in fgets_chunks(data, read_length)]


def load_reads_fast(path: str) -> List[str]:
    """Load reads: one read per line, newline stripped, no truncation.

    Accepts plain one-read-per-line files and FASTA ('>' header lines are
    skipped and sequences are NOT joined across lines -- long-read FASTA
    should be pre-flattened or fed through load_fasta).
    """
    out = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(">"):
                continue
            out.append(line)
    return out


def load_fasta(path: str) -> List[str]:
    """Load FASTA records, joining sequence lines per record."""
    out: List[str] = []
    cur: List[str] = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if cur:
                    out.append("".join(cur))
                    cur = []
            elif line:
                cur.append(line)
    if cur:
        out.append("".join(cur))
    return out


def validate_acgt(reads: Sequence[str]) -> None:
    """Raise unless every read is pure uppercase ACGT.

    The reference scores a non-ACGT character as 'A' but prints it
    verbatim where the k-mer is not complemented, which the 2-bit packed
    tables cannot carry; paths that cannot take the exception route
    (``parity/nonacgt.py``) reject such reads instead of mismatching.
    """
    for i, r in enumerate(reads):
        if not _ACGT.issuperset(r):
            bad = sorted(set(r) - _ACGT)
            raise ValueError(
                f"parity mode requires ACGT-only reads; read {i} contains "
                f"{bad} (the reference would score these as 'A' but print "
                "them verbatim, which 2-bit packing cannot represent)"
            )


@dataclasses.dataclass
class ReadBatch:
    """A padded batch of reads, ready to copy to the device.

    codes: [n, max_len] uint8, 2-bit base codes, zero-padded.
    lengths: [n] int32 actual lengths.
    read_ids: [n] uint32 global read ids.
    """

    codes: np.ndarray
    lengths: np.ndarray
    read_ids: np.ndarray

    @property
    def n(self) -> int:
        return self.codes.shape[0]


def batch_reads(
    reads: Sequence[str],
    max_len: int,
    batch_size: int | None = None,
    start_id: int = 0,
    parity_chars: bool = False,
) -> List[ReadBatch]:
    """Encode and pad reads into fixed-shape batches.

    Every read (even empty ones) consumes a read id.  Reads longer than
    ``max_len`` are rejected here; long sequences are chunked first
    (``chunk_long_sequence``).

    parity_chars: encode with the reference's exact table (only uppercase
    TGCA are real; everything else scores as 'A') instead of the lenient
    fast-mode table that accepts lowercase bases.

    Each batch is encoded in one table lookup over the joined bytes of its
    reads (span ``encode``, with the length check up front) and scattered
    into the padded rows (span ``scatter``).
    """
    ids = np.arange(start_id, start_id + len(reads), dtype=np.uint32)
    with profiling.span("encode"):
        for r in reads:
            if len(r) > max_len:
                raise ValueError(
                    f"read of length {len(r)} exceeds max_read_len={max_len}; "
                    "use the long-sequence chunking path"
                )
    if batch_size is None:
        batch_size = max(1, len(reads))
    table = encode._ASCII_TO_CODE_REF if parity_chars else encode._ASCII_TO_CODE
    charset = "latin-1" if parity_chars else "utf-8"
    batches = []
    for ofs in range(0, max(len(reads), 1), batch_size):
        chunk = reads[ofs : ofs + batch_size]
        if not chunk:
            break
        n = len(chunk)
        with profiling.span("encode"):
            lengths = np.fromiter(map(len, chunk), dtype=np.int32, count=n)
            flat = np.frombuffer("".join(chunk).encode(charset), dtype=np.uint8)
            if flat.size != int(lengths.sum()):
                raise ValueError("reads must be single-byte characters")
            values = table[flat]
        with profiling.span("scatter"):
            starts = np.zeros(n, dtype=np.int64)
            np.cumsum(lengths[:-1], out=starts[1:])
            row = np.repeat(np.arange(n, dtype=np.int64), lengths)
            col = np.arange(flat.size, dtype=np.int64) - np.repeat(starts, lengths)
            codes = np.zeros((n, max_len), dtype=np.uint8)
            codes[row, col] = values
        batches.append(ReadBatch(codes, lengths, ids[ofs : ofs + n]))
    return batches


def chunk_long_sequence(seq: str, chunk_len: int, k: int) -> List[str]:
    """Split a long sequence into chunks overlapping by k-1 bases.

    Every k-window of the original sequence appears in exactly one chunk
    (the one owning its start position).
    """
    if chunk_len < k:
        raise ValueError(f"chunk_len {chunk_len} must be >= k {k}")
    step = chunk_len - (k - 1)
    out = []
    for start in range(0, max(len(seq) - (k - 1), 1), step):
        chunk = seq[start : start + chunk_len]
        if len(chunk) >= k or start == 0:
            out.append(chunk)
    return out


def pad_batch(batch: ReadBatch, to_n: int) -> ReadBatch:
    """Pad a batch with empty reads up to ``to_n`` rows."""
    n = batch.n
    if n == to_n:
        return batch
    if n > to_n:
        raise ValueError(f"batch of {n} cannot pad down to {to_n}")
    codes = np.zeros((to_n, batch.codes.shape[1]), dtype=np.uint8)
    codes[:n] = batch.codes
    lengths = np.zeros(to_n, dtype=np.int32)
    lengths[:n] = batch.lengths
    read_ids = np.zeros(to_n, dtype=np.uint32)
    read_ids[:n] = batch.read_ids
    return ReadBatch(codes, lengths, read_ids)

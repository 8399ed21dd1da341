"""Read loading and batching, on the host in numpy.  ``batch_reads`` times
its two steps as spans of the run in progress (``utils/profiling.span``):
``encode`` and ``scatter`` of the ``batch`` phase.  ``flat_batches``, fast
mode's batcher, only gathers each batch's bases (span ``encode``): the
stager (io/stream.py) pads and encodes them on the device.

Fast mode loads a file as a ``ReadTable`` (``load_read_table``): the file's
bytes, read once, and the start and length of each read among them.  It
reads as the list of strings ``load_reads_fast`` returns, and
``flat_batches`` ships each batch's span of the file as it lies, so no
read becomes a string on the way to the device.

Parity mode reproduces the reference driver's input handling exactly:
``fgets(read, READ_LENGTH=101, file)`` reads at most 100 characters per
call, and the driver then chops the final character of whatever it got
(assuming it was the newline).  So a 100-bp line becomes a 99-bp read
(its last base chopped) and an empty read (the newline left unread), each
consuming a read id of its own.  Fast mode reads one sequence per line.
"""

from __future__ import annotations

import dataclasses
import operator
import os
import stat
from collections import abc
from typing import Iterator, List, Sequence, Union

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


# the bytes below 0x80 that ``str.strip`` removes
_STRIPPED = np.zeros(256, dtype=bool)
_STRIPPED[[9, 10, 11, 12, 13, 28, 29, 30, 31, 32]] = True
# bytes a pass of the line search compares at once (a cache's worth)
_SCAN_BYTES = 1 << 22
# bytes of a file tried before the whole of it is read
_HEAD_BYTES = 1 << 16
_INT32_MAX = np.iinfo(np.int32).max
# reads a step of a ReadTable's iteration makes
_ITER_READS = 1 << 16


class ReadTable(abc.Sequence):
    """A file's reads as a table of lines over its bytes, read only: as the
    list of str ``load_reads_fast`` returns, each read made a str only when
    it is read.  ``[i]`` makes one; ``[a:b]`` makes a list in bulk (one
    decode and one split where no skipped line lies among them).

    data: [size] uint8, the file's bytes, as ``load_read_table`` read them.
    starts: [n] int64, each read's first byte in ``data``.
    lengths: [n] int32, each read's length.
    """

    def __init__(self, data: np.ndarray, starts: np.ndarray, lengths: np.ndarray):
        for a in (data, starts, lengths):
            a.flags.writeable = False
        self.data, self.starts, self.lengths = data, starts, lengths

    def __len__(self) -> int:
        return self.lengths.shape[0]

    def __getitem__(self, i):
        if isinstance(i, slice):
            a, b, step = i.indices(len(self))
            if step != 1:
                return [self[j] for j in range(a, b, step)]
            return self._reads(a, b)
        n = len(self)
        j = operator.index(i)
        if not -n <= j < n:
            raise IndexError(f"read {i} of {n}")
        s = int(self.starts[j])
        return self.data[s : s + int(self.lengths[j])].tobytes().decode("ascii")

    def _reads(self, a: int, b: int) -> List[str]:
        if a >= b:
            return []
        first = int(self.starts[a])
        end = int(self.starts[b - 1]) + int(self.lengths[b - 1])
        text = self.data[first:end].tobytes().decode("ascii")
        if end - first == int(self.lengths[a:b].sum()) + b - a - 1:
            # one newline between each read and the next: no line skipped
            return text.split("\n")
        return [text[s : s + n] for s, n in
                zip((self.starts[a:b] - first).tolist(), self.lengths[a:b].tolist())]

    def __iter__(self) -> Iterator[str]:
        for a in range(0, len(self), _ITER_READS):
            yield from self._reads(a, min(a + _ITER_READS, len(self)))

    def __eq__(self, other) -> bool:
        if not isinstance(other, abc.Sequence) or isinstance(other, (str, bytes)):
            return NotImplemented
        return len(self) == len(other) and self[:] == list(other)

    __hash__ = None


def _newlines(data: np.ndarray) -> np.ndarray:
    """The positions of the newlines in ``data``, int64, a cache's worth of
    bytes a pass."""
    found = [np.flatnonzero(data[o : o + _SCAN_BYTES] == ord("\n")) + o
             for o in range(0, data.size, _SCAN_BYTES)]
    return np.concatenate(found) if found else np.zeros(0, dtype=np.int64)


def _line_table(buf: bytes):
    """The int64 starts and int32 lengths of the lines ``load_reads_fast``
    keeps of ``buf`` (neither blank nor ``>``), or None where its text mode
    and ``str.strip`` would change more than that: ``buf`` holds a ``\\r``
    (which also ends a line in text mode) or a byte of 0x80 or above (UTF-8),
    or a kept line starts or ends with a byte ``strip`` removes, or has 2^31
    bytes, past an int32 length."""
    if b"\r" in buf or not buf.isascii():
        return None
    data = np.frombuffer(buf, dtype=np.uint8)
    ends = _newlines(data)
    if data.size and data[-1] != ord("\n"):
        ends = np.append(ends, data.size)  # the last line has no newline
    starts = np.zeros(ends.size, dtype=np.int64)
    starts[1:] = ends[:-1] + 1
    lengths = ends - starts
    first = data[starts]  # a blank line's first byte is its newline
    kept = (lengths > 0) & (first != ord(">"))
    if not kept.all():
        starts, lengths, first = starts[kept], lengths[kept], first[kept]
    if (_STRIPPED[first].any() or _STRIPPED[data[starts + lengths - 1]].any()
            or (lengths.size and lengths.max() > _INT32_MAX)):
        return None
    return starts, lengths.astype(np.int32)


def load_read_table(path: str) -> Union[ReadTable, List[str]]:
    """``load_reads_fast(path)``'s reads, from one read of the file: a
    ``ReadTable`` over a copy of its bytes where that is exact
    (``_line_table``), else ``load_reads_fast``'s list, with its errors.

    Only a regular file is read this way: a pipe or a FIFO cannot be read a
    second time should the table not be exact.  The file's first
    ``_HEAD_BYTES`` are tried first, so a file whose first lines are not
    exact (CRLF line ends, say) costs no more than a read of them."""
    if not stat.S_ISREG(os.stat(path).st_mode):
        return load_reads_fast(path)
    with open(path, "rb") as f:
        head = f.read(_HEAD_BYTES)
        if _line_table(head[: head.rfind(b"\n") + 1]) is None:
            return load_reads_fast(path)
        f.seek(0)
        buf = f.read()
    found = _line_table(buf)
    if found is None:
        return load_reads_fast(path)
    return ReadTable(np.frombuffer(buf, dtype=np.uint8), *found)


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


def _too_long(length: int, max_len: int) -> ValueError:
    return ValueError(
        f"read of length {length} exceeds max_read_len={max_len}; raise "
        "max_read_len (the CLI's --max-read-len) to at least the longest "
        "read, e.g. --max-read-len 150 for 150-bp reads (sequences longer "
        "than reads, such as contigs or genomes, are chunked instead: "
        "unitigs_from_sequences, assemble --fasta)"
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
    ``max_len`` are rejected here, with an error that names
    ``max_read_len`` and the CLI's ``--max-read-len``; sequences longer
    than reads are chunked first (``chunk_long_sequence``).

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
                raise _too_long(len(r), max_len)
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


@dataclasses.dataclass
class FlatBatch:
    """A batch of reads as their bases, unpadded and not encoded: what fast
    mode copies to the device, where ``ops/pack_rows`` turns it into a
    ``ReadBatch``'s rows (``width`` wide).

    bases: uint8, the bytes that hold the reads' ASCII bases: a span of the
      reads one after another, or of a ``ReadTable``'s file from the first
      read to the end of the last, lines between included.
    starts: [n] int32, each read's first base in ``bases``.
    lengths: [n] int32 actual lengths (0 for a padding row).
    read_ids: [n] int64 global read ids (0 for a padding row), as staged.
    """

    bases: np.ndarray
    starts: np.ndarray
    lengths: np.ndarray
    read_ids: np.ndarray
    width: int

    @property
    def n(self) -> int:
        return self.lengths.shape[0]


def _exclusive_sum(lengths: np.ndarray, dtype) -> np.ndarray:
    """The start of each read among bases that hold the reads one after
    another."""
    starts = np.zeros(len(lengths), dtype=dtype)
    np.cumsum(lengths[:-1], out=starts[1:])
    return starts


def flat_batches(reads: Sequence[str], max_len: int, batch_size: int) -> List[FlatBatch]:
    """Fast mode's batches, ``batch_reads`` + ``pad_batch`` as the fast
    pipelines call them, with the padding and the encoding left to the
    device: several batches have ``batch_size`` rows each, the last padded
    with empty reads; a lone batch keeps its own rows.  Read ids count from
    0.  The same errors as ``batch_reads``: a read longer than ``max_len``
    (one check over the whole set, before any batch) and a read of
    characters wider than a byte.

    Each batch's bases are its span of a table's bytes, a view: a
    ``ReadTable``'s (counted as ``line_table``), or the table any other
    sequence makes of its reads joined, with nothing between them."""
    n_reads = len(reads)
    table = isinstance(reads, ReadTable)
    with profiling.span("encode"):
        if table:
            profiling.count("line_table", 1)
            data, starts, lengths = reads.data, reads.starts, reads.lengths
        else:
            lengths = np.fromiter(map(len, reads), dtype=np.int32, count=n_reads)
        if n_reads and int(lengths.max()) > max_len:
            raise _too_long(int(lengths[np.argmax(lengths > max_len)]), max_len)
        if not table:
            data = np.frombuffer("".join(reads).encode(), dtype=np.uint8)
            if data.size != int(lengths.sum()):
                raise ValueError("reads must be single-byte characters")
            starts = _exclusive_sum(lengths, np.int64)
    rows = batch_size if n_reads > batch_size else n_reads
    batches = []
    for ofs in range(0, n_reads, batch_size):
        n = min(batch_size, n_reads - ofs)
        with profiling.span("encode"):
            length = np.zeros(rows, dtype=np.int32)
            length[:n] = lengths[ofs : ofs + n]
            first = int(starts[ofs])
            end = int(starts[ofs + n - 1]) + int(length[n - 1])
            start = np.zeros(rows, dtype=np.int32)
            if end - first <= _INT32_MAX:
                bases = data[first:end]
                start[:n] = starts[ofs : ofs + n] - first
            else:  # reads among 2 GiB of '>' or blank lines: a start past an int32
                bases = np.concatenate([data[s : s + k] for s, k in
                                        zip(starts[ofs : ofs + n].tolist(), length[:n].tolist())])
                start = _exclusive_sum(length, np.int32)
            ids = np.zeros(rows, dtype=np.int64)
            ids[:n] = np.arange(ofs, ofs + n)
        batches.append(FlatBatch(bases, start, length, ids, max_len))
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

"""Fast mode's load from one read of the file (``io/reads.load_read_table``).

``FastAssembler.load`` returns a ``ReadTable`` over the file's bytes where
that is exact, and ``load_reads_fast``'s list elsewhere: either way the reads
``load_reads_fast`` reads, with its errors, and the batches of those reads
with ``flat_batches``' errors.  The table reads as that list: length,
indices, slices, iteration and equality.  This file imports no JAX.
"""

import os
import threading

import numpy as np
import pytest

from genome_assembly_tpu_torch.config import PipelineConfig
from genome_assembly_tpu_torch.io import reads as treads
from genome_assembly_tpu_torch.models.pipeline import FastAssembler, PhaseStats
from genome_assembly_tpu_torch.utils import profiling


def _lines(n, length, seed, letters=b"ACGT"):
    rng = np.random.default_rng(seed)
    rows = np.frombuffer(letters, dtype=np.uint8)[rng.integers(0, len(letters), (n, length))]
    return [r.tobytes() for r in rows]


R100, R150 = _lines(50, 100, 1), _lines(40, 150, 2)
SHORT = _lines(12, 30, 3)


def _join(lines, end=b"\n"):
    return b"".join(line + end for line in lines)


# file bytes, and whether load makes a table of them (else load_reads_fast's list)
CASES = {
    "plain_100bp": (_join(R100), True),
    "plain_150bp": (_join(R150), True),
    "no_final_newline": (_join(SHORT)[:-1], True),
    "blank_lines": (b"\n\n" + _join(SHORT[:4]) + b"\n\n\n" + _join(SHORT[4:]) + b"\n", True),
    "headers": (b"".join(b">read_%d len=30\n" % i + s + b"\n" for i, s in enumerate(SHORT)),
                True),
    "header_last_without_newline": (_join(SHORT) + b">tail", True),
    "inner_spaces_and_tabs": (b"AC GT\nAC\tGT\n" + _join(SHORT), True),
    "lowercase_and_iupac": (_join(_lines(20, 40, 4, b"acgtACGTNnRYKM*")), True),
    "over_length": (_join(SHORT) + b"A" * 200 + b"\n", True),
    "empty_file": (b"", True),
    "only_headers": (b">a\n>b\n>c\n", True),
    "only_newlines": (b"\n\n\n", True),
    "crlf": (_join(SHORT, b"\r\n"), False),
    "lone_cr": (_join(SHORT, b"\r"), False),
    "cr_inside_a_line": (_join(SHORT[:3]) + b"ACGT\rTTGA\n" + _join(SHORT[3:]), False),
    "cr_inside_a_header": (b">h\rACGTACGT\n" + _join(SHORT), False),
    "leading_spaces": (b"  " + _join(SHORT), False),
    "trailing_tab": (SHORT[0] + b"\t\n" + _join(SHORT[1:]), False),
    "blank_line_of_spaces": (_join(SHORT[:2]) + b"   \n" + _join(SHORT[2:]), False),
    "form_feed_at_an_end": (_join(SHORT) + b"ACGT\x0c\n", False),
    "unit_separator_at_a_start": (b"\x1fACGT\n" + _join(SHORT), False),
    "spaced_header": (b" >h\n" + _join(SHORT), False),
    "multibyte_utf8_base": (_join(SHORT) + "ACGé\n".encode(), False),
    "invalid_utf8": (_join(SHORT) + b"AC\xffGT\n", False),
}


def _load(tmp_path, content):
    path = tmp_path / "reads.txt"
    path.write_bytes(content)
    asm = FastAssembler(PipelineConfig(k=21, m=7, parity=False), device="cpu")
    return str(path), asm.load


def _outcome(fn, *args):
    """What fn returns, or the type and words of the error it raises."""
    try:
        return fn(*args)
    except (ValueError, UnicodeDecodeError) as e:
        return type(e), str(e)


def _batches(reads):
    """flat_batches' reads as lists of bytes, or its error."""
    batches = _outcome(treads.flat_batches, reads, 128, 8)
    if isinstance(batches, tuple):
        return batches
    return [[b.bases[s : s + n].tobytes() for s, n in zip(b.starts, b.lengths)] for b in batches]


@pytest.mark.parametrize("case", list(CASES))
def test_load_reads_what_load_reads_fast_reads(tmp_path, case):
    """The reads, or the error, of ``load_reads_fast``; a table exactly where
    the file holds no carriage return and no byte past ASCII, and no read
    starts or ends with what ``str.strip`` removes; and the batches of the
    table are those of the list, errors included."""
    content, table = CASES[case]
    path, load = _load(tmp_path, content)
    want = _outcome(treads.load_reads_fast, path)
    got = _outcome(load, path)
    if isinstance(want, tuple):
        assert got == want and want[0] is UnicodeDecodeError and not table
        return
    assert isinstance(got, treads.ReadTable) == table
    assert isinstance(got, list) == (not table)
    assert list(got) == want and got == want and len(got) == len(want)
    assert _batches(got) == _batches(want)


OPS = {
    "len": len,
    "index": lambda r: r[3],
    "index_numpy_int": lambda r: r[np.int64(5)],
    "negative_index": lambda r: r[-1],
    "negative_index_first": lambda r: r[-len(r)],
    "index_past_the_end": lambda r: _outcome_index(r, len(r)),
    "negative_index_past_the_start": lambda r: _outcome_index(r, -len(r) - 1),
    "slice": lambda r: r[2:9],
    "slice_across_headers": lambda r: r[5:17],
    "slice_from_the_start": lambda r: r[:4],
    "slice_to_the_end": lambda r: r[15:],
    "slice_negative_bounds": lambda r: r[-6:-2],
    "slice_past_the_end": lambda r: r[10:1000],
    "slice_empty": lambda r: r[9:3],
    "slice_with_step": lambda r: r[1:20:3],
    "slice_reversed": lambda r: r[::-2],
    "whole": lambda r: r[:],
    "iteration": list,
    "reversed": lambda r: list(reversed(r)),
    "contains": lambda r: (r[7] in r, "ACGT" in r),
    "index_and_count": lambda r: (r.index(r[11]), r.count(r[11])),
}


def _outcome_index(reads, i):
    try:
        return reads[i]
    except IndexError:
        return IndexError


# reads between headers and blank lines, then a run with none between them
MIXED = (b">a\n" + _join(SHORT[:5]) + b"\n>b\n\n" + _join(SHORT[5:9]) + b">c\n"
         + _join(_lines(12, 20, 5)))


@pytest.mark.parametrize("op", list(OPS))
def test_a_table_reads_as_its_list(tmp_path, monkeypatch, op):
    """Each operation of a sequence gives on the table what it gives on
    ``load_reads_fast``'s list; iteration in steps of a few reads."""
    monkeypatch.setattr(treads, "_ITER_READS", 4)
    path, load = _load(tmp_path, MIXED)
    table, want = load(path), treads.load_reads_fast(path)
    assert isinstance(table, treads.ReadTable) and len(want) == 21
    assert OPS[op](table) == OPS[op](want)


@pytest.mark.parametrize("other,equal", [
    ("its_list", True), ("its_tuple", True), ("one_read_changed", False),
    ("one_read_fewer", False), ("a_string", False), ("itself", True)])
def test_a_table_equals_the_list_of_its_reads(tmp_path, other, equal):
    path, load = _load(tmp_path, MIXED)
    table, want = load(path), treads.load_reads_fast(path)
    changed = list(want)
    changed[4] = changed[4][:-1] + ("A" if changed[4][-1] != "A" else "C")
    value = {"its_list": want, "its_tuple": tuple(want), "one_read_changed": changed,
             "one_read_fewer": want[:-1], "a_string": "".join(want), "itself": table}[other]
    assert (table == value) is equal and (value == table) is equal
    assert (table != value) is not equal


def test_a_table_is_read_only(tmp_path):
    path, load = _load(tmp_path, _join(SHORT))
    table = load(path)
    with pytest.raises(TypeError):
        table[0] = "ACGT"
    for a in (table.data, table.starts, table.lengths):
        with pytest.raises(ValueError):
            a[0] = 0


@pytest.mark.parametrize("source", ["table", "list"])
def test_flat_batches_count_line_table_on_a_table(tmp_path, source):
    """``line_table`` is 1 for a table's batches, inside the batch phase,
    and absent for a list's."""
    path, load = _load(tmp_path, _join(R100))
    reads = load(path) if source == "table" else treads.load_reads_fast(path)
    stats = PhaseStats()
    with profiling.PhaseClock(stats, phase="batch"):
        batches = treads.flat_batches(reads, 128, 16)
    assert len(batches) == 4
    assert stats.counts == ({"line_table": 1} if source == "table" else {})


@pytest.mark.parametrize("case", ["plain_100bp", "headers", "crlf", "empty_file"])
def test_a_pipe_reads_what_load_reads_fast_reads(tmp_path, case):
    """A FIFO (as ``<(zcat reads.gz)`` or ``/dev/stdin`` give) is read once,
    by ``load_reads_fast``: its reads, as a list."""
    content, _ = CASES[case]
    path, load = _load(tmp_path, content)
    fifo = str(tmp_path / "reads.fifo")
    os.mkfifo(fifo)

    def write():
        with open(fifo, "wb") as f:
            f.write(content)

    got = {}
    threads = [threading.Thread(target=write, daemon=True),
               threading.Thread(target=lambda: got.update(reads=load(fifo)), daemon=True)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert "reads" in got, "load did not read the pipe once through"
    assert isinstance(got["reads"], list) and got["reads"] == treads.load_reads_fast(path)


@pytest.mark.parametrize("change", ["rewritten", "truncated", "removed"])
def test_a_table_keeps_the_reads_of_the_file_as_it_was_read(tmp_path, change):
    """The table holds a copy of the file's bytes: what happens to the file
    afterwards leaves its reads and its batches as they were."""
    path, load = _load(tmp_path, _join(R100))
    table = load(path)
    want = treads.load_reads_fast(path)
    if change == "rewritten":
        with open(path, "r+b") as f:
            f.write(_join(R150)[: len(_join(R100))])
    elif change == "truncated":
        os.truncate(path, 0)
    else:
        os.unlink(path)
    assert isinstance(table, treads.ReadTable) and table == want
    assert _batches(table) == _batches(want)


LATE = _join(_lines(40, 100, 6))  # more bytes than the head tried first


@pytest.mark.parametrize("content,tries,table", [
    (LATE, 2, True),
    (_join(_lines(40, 100, 6), b"\r\n"), 1, False),
    (b" " + LATE, 1, False),
    ("é".encode() + LATE, 1, False),
    (LATE + b"ACGT\r\n", 2, False),
    (LATE + b"ACGT \n", 2, False),
], ids=["plain", "crlf", "leading_space", "multibyte_first", "cr_late", "space_late"])
def test_a_file_not_exact_in_its_first_lines_is_read_no_further(tmp_path, monkeypatch, content,
                                                              tries, table):
    """The first ``_HEAD_BYTES`` of a file are tried before the whole: a
    file whose first lines need ``load_reads_fast`` takes it from there
    (one try); else the whole file is tried (two).  The reads are
    ``load_reads_fast``'s either way."""
    monkeypatch.setattr(treads, "_HEAD_BYTES", 1000)
    calls = []
    line_table = treads._line_table
    monkeypatch.setattr(treads, "_line_table", lambda b: calls.append(len(b)) or line_table(b))
    path, load = _load(tmp_path, content)
    got = load(path)
    assert len(calls) == tries and calls[0] <= 1000
    assert isinstance(got, treads.ReadTable) == table
    assert got == treads.load_reads_fast(path)

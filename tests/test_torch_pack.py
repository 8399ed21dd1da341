"""Fast mode's flat batches and the row packer (ops/pack_rows.py).

On the CPU: ``io/reads.flat_batches``, staged by the CPU stager, gives the
rows, lengths and read ids that ``batch_reads`` + ``pad_batch`` give, with
the same errors, and ``FastAssembler.unitigs`` the same unitigs as through
the padded batches, in core and out of core; from a list of reads and from
the line table ``FastAssembler.load`` makes of a file, whose batches are
spans of the file.  The ``card`` cases hold the
packer on the card to ``batch_reads`` at 128- and 256-base rows, staging to
no synchronising call, and ``packed_batches`` to the batches an assembly
stages; they skip without a card.  This file imports no JAX, so on a card:

    python -m pytest tests/test_torch_pack.py --noconftest -m card -q
"""

import numpy as np
import pytest
import torch

from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.config import PipelineConfig
from genome_assembly_tpu_torch.io import datagen
from genome_assembly_tpu_torch.io import reads as treads
from genome_assembly_tpu_torch.io import stream as tstream
from genome_assembly_tpu_torch.models.pipeline import FastAssembler, PhaseStats
from genome_assembly_tpu_torch.ops import encode, pack_rows
from genome_assembly_tpu_torch.utils import profiling

LETTERS = list("ACGT")
ODD_LETTERS = list("ACGTacgtNnRYKM*")


def _reads(n, lo, hi, letters=LETTERS, seed=0):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(letters, size=int(rng.integers(lo, hi + 1))))
            for _ in range(n)]


def _padded(reads, max_len, rows):
    """The fast pipelines' batches before flat ones: ``batch_reads``, the
    last padded to ``rows`` when there are several."""
    batches = treads.batch_reads(reads, max_len, rows)
    if len(batches) > 1:
        batches[-1] = treads.pad_batch(batches[-1], rows)
    return batches


def _file(tmp_path, text):
    """The line table ``FastAssembler.load`` makes of a file of ``text``."""
    path = tmp_path / "reads.txt"
    path.write_bytes(text)
    table = FastAssembler(PipelineConfig(k=21, m=7, parity=False), device="cpu").load(str(path))
    assert isinstance(table, treads.ReadTable)
    return table


def _text(reads, every=0):
    """A file of the reads, one a line, a ``>`` line before every
    ``every``-th read (none for 0)."""
    return "".join((f">r{i}\n" if every and i % every == 0 else "") + r + "\n"
                   for i, r in enumerate(reads)).encode()


# (reads, max_len, batch rows); reads as bytes: the line table of that file
CASES = {
    "empty_reads": (["", *_reads(20, 0, 30, seed=1), "", ""], 32, 8),
    "only_empty_reads": ([""] * 11, 16, 4),
    "reads_of_max_len": (_reads(19, 48, 48, seed=2), 48, 8),
    "partial_last_batch": (_reads(37, 5, 64, seed=3), 64, 16),
    "single_batch": (_reads(5, 10, 40, seed=4), 40, 16),
    "exactly_one_full_batch": (_reads(16, 10, 40, seed=5), 40, 16),
    "lowercase_and_non_acgt": (_reads(30, 0, 50, ODD_LETTERS, seed=6), 50, 8),
    "150bp_in_256_rows": (_reads(40, 150, 150, seed=7), 256, 16),
    "odd_width": (_reads(25, 1, 37, ODD_LETTERS, seed=8), 37, 8),
    "table_one_batch": (_text(_reads(13, 90, 100, seed=13)), 128, 16),
    "table_several_batches_last_padded": (_text(_reads(45, 1, 50, ODD_LETTERS, seed=14)), 50, 8),
    "table_headers_inside_spans": (_text(_reads(30, 150, 150, seed=15), every=3), 256, 8),
    "table_150bp_in_256_rows": (_text(_reads(40, 150, 150, seed=16)), 256, 16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flat_batches_staged_on_the_cpu_equal_the_padded_batches(tmp_path, case):
    """Each flat batch, packed by the CPU stager, is the padded batch as
    ``convert.read_batch_to_torch`` gives it; what staging counts is the
    bases and 16 bytes a row, and one packed batch each.  A list's bases
    are its reads joined; a table's, its file from a batch's first read to
    the end of its last, a view of the file's bytes."""
    reads, max_len, rows = CASES[case]
    table = isinstance(reads, bytes)
    if table:
        reads = _file(tmp_path, reads)
    flat = treads.flat_batches(reads, max_len, rows)
    want = _padded(list(reads), max_len, rows)
    assert len(flat) == len(want)
    stats = PhaseStats()
    with profiling.PhaseClock(stats, phase="scan"):
        with tstream.feed_read_batches(flat, "cpu") as feeder:
            got = list(feeder)
    for (codes, lengths, rids), f, w in zip(got, flat, want):
        n = int((w.lengths > 0).sum()) if table else int(w.lengths.sum())
        span = int(f.starts[n - 1] + f.lengths[n - 1]) if table else n
        assert f.n == w.n and f.width == max_len and f.bases.size == span
        assert np.shares_memory(f.bases, reads.data) if table else True
        assert (codes.dtype, lengths.dtype, rids.dtype) == (torch.uint8, torch.int32, torch.int64)
        for x, y in zip((codes, lengths, rids), convert.read_batch_to_torch(w)):
            assert torch.equal(x, y)
    bases = sum(f.bases.size for f in flat) if table else sum(map(len, reads))
    assert stats.counts == {"packed_batches": len(flat),
                            "h2d_bytes": bases + 16 * sum(w.n for w in want)}


def test_a_span_past_an_int32_start_is_joined(tmp_path, monkeypatch):
    """Where a batch's span of the file would put a start past an int32
    (here: past a limit set low), that batch's reads are joined as a
    list's, and the rows are the same."""
    reads = _reads(40, 20, 40, seed=17)
    table = _file(tmp_path, _text(reads, every=4))
    want = treads.flat_batches(table, 64, 16)
    # the last batch, of 8 reads, fits; the two full ones do not
    monkeypatch.setattr(treads, "_INT32_MAX", want[-1].bases.size)
    got = treads.flat_batches(table, 64, 16)
    assert [np.shares_memory(f.bases, table.data) for f in got] == [False, False, True]
    for g, w in zip(got, want, strict=True):
        for x, y in zip(tstream._stage_on_host(g), tstream._stage_on_host(w)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("reads,max_len,match", [
    (["ACGT", "A" * 49, "ACGT" * 20], 48, "read of length 49 exceeds max_read_len=48"),
    (["ACGT"] * 9 + ["ACGTé"], 48, "reads must be single-byte characters"),
    # the length check covers the whole set before any batch, as batch_reads does
    (["ACGTé"] + ["ACGT"] * 9 + ["A" * 60], 48, "read of length 60 exceeds"),
    (_text(["ACGT"] * 9 + ["A" * 49, "ACGT" * 20], every=4), 48,
     "read of length 49 exceeds max_read_len=48"),
], ids=["over_length", "multibyte", "over_length_first", "table_over_length"])
def test_flat_batches_refuse_what_batch_reads_refuses(tmp_path, reads, max_len, match):
    if isinstance(reads, bytes):
        reads = _file(tmp_path, reads)
    with pytest.raises(ValueError) as want:
        treads.batch_reads(reads, max_len, 4)
    with pytest.raises(ValueError, match=match) as got:
        treads.flat_batches(reads, max_len, 4)
    assert str(got.value) == str(want.value)


def test_the_pinned_rings_routes_on_the_cpu(monkeypatch):
    """The card's stager (pinned ring, side stream, events) with its CUDA
    calls stubbed: flat batches of two widths, then padded ones, through one
    ring of two slots, each as its padded batch."""
    import contextlib

    class Event:
        def record(self, stream=None):
            pass

        def synchronize(self):
            pass

    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **kw: real_empty(*a, **kw))
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: object())
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    ring = tstream._PinnedRing(torch.device("cpu"), 2)
    reads = _reads(70, 0, 50, ODD_LETTERS, seed=9)
    for width, rows in ((64, 16), (50, 32)):
        want = _padded(reads, width, rows)
        for batch, w in [*zip(treads.flat_batches(reads, width, rows), want), *zip(want, want)]:
            got, _ = ring(batch)
            for x, y in zip(got, convert.read_batch_to_torch(w)):
                assert torch.equal(x, y)


def test_plain_pack_rows_keeps_inside_its_rows_and_its_bases():
    """The packer's guards: a length past the width is cut to it, a negative
    one is an empty row, a base outside the bases reads 0."""
    bases = torch.tensor(list(b"ACGTacgtNA"), dtype=torch.uint8)
    starts = torch.tensor([0, 4, 8, -2, 6], dtype=torch.int32)
    lengths = torch.tensor([4, 9, 3, 3, -1], dtype=torch.int32)
    table = pack_rows.ascii_table("cpu")
    codes = pack_rows.pack_rows_plain(bases, starts, lengths, table, 6)
    row = lambda s: list(encode._ASCII_TO_CODE[np.frombuffer(s, dtype=np.uint8)])
    assert codes.tolist() == [row(b"ACGT") + [0, 0], row(b"acgtNA"), row(b"NA") + [0] * 4,
                              [0, 0] + row(b"A") + [0] * 3, [0] * 6]


def _assembly_reads():
    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=2000, read_len=70, coverage=8, seed=11, with_reverse=True)
    return [r.lower() if i % 7 == 0 else r for i, r in enumerate(reads)]


@pytest.mark.parametrize("outofcore_bytes,loaded", [
    (3 << 30, False), (1 << 14, False), (3 << 30, True), (1 << 14, True)],
    ids=["incore", "outofcore", "incore_table", "outofcore_table"])
def test_unitigs_are_those_of_the_padded_batches(tmp_path, monkeypatch, outofcore_bytes, loaded):
    """The unitigs of the reads, or of the line table of their file, are
    those of the padded batches of the reads."""
    reads = _assembly_reads()
    cfg = PipelineConfig(k=21, m=7, parity=False, batch_reads=64, max_read_len=96,
                         outofcore_bytes=outofcore_bytes)
    got, stats = FastAssembler(cfg, device="cpu").unitigs(
        _file(tmp_path, _text(reads, every=5)) if loaded else reads)
    assert stats.counts["packed_batches"] >= -(-len(reads) // 64) > 1
    assert stats.counts.get("line_table") == (1 if loaded else None)
    # the fast pipelines as before flat batches: padded rows encoded on the
    # host, staged as they are
    monkeypatch.setattr(treads, "flat_batches", _padded)
    want, before = FastAssembler(cfg, device="cpu").unitigs(reads)
    assert got == want and len(got) > 1
    assert "packed_batches" not in before.counts
    assert stats.counts["slots"] == before.counts["slots"]
    assert stats.counts["windows"] == before.counts["windows"]
    assert stats.counts["h2d_bytes"] < before.counts["h2d_bytes"]


@pytest.mark.parametrize("changed", [False, True], ids=["as_written", "one_base_changed"])
def test_the_benchmarks_reads_diff_reads_a_table(tmp_path, changed):
    """The benchmark judges ingest on what ``load`` returns, with
    ``reads_diff`` against the reads written: 0 on the table of their file,
    1 where one base of the file was changed."""
    from gabench.reference.dbg_unitigs import reads_diff

    made = np.frombuffer(b"ACGT", dtype=np.uint8)[
        np.random.default_rng(18).integers(0, 4, (300, 100))]
    text = bytearray(b"".join(r.tobytes() + b"\n" for r in made))
    if changed:
        text[101 * 150 + 42] = ord("A") if text[101 * 150 + 42] != ord("A") else ord("C")
    assert reads_diff(made, _file(tmp_path, bytes(text))) == int(changed)


# --- on a card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("width,read_len", [(128, 100), (256, 150)])
def test_k0_on_the_card_is_its_plain_version_and_batch_reads(card, width, read_len):
    """A whole batch of the benchmark's shapes, 16,384 rows, with empty
    reads, reads of the full width, lowercase and non-ACGT letters."""
    reads = _reads(16384, read_len - 20, read_len, ODD_LETTERS, seed=width)
    reads[:3] = ["", "A" * width, "acgtn" * (width // 5)]
    (flat,) = treads.flat_batches(reads, width, 16384)
    (want,) = treads.batch_reads(reads, width, 16384)
    host = tstream._flat_host(flat)
    cpu = [torch.from_numpy(a.copy()) for a in host[:3]]
    dev = [t.to(card) for t in cpu]
    codes = pack_rows.pack_rows_plain(*dev, pack_rows.ascii_table(card), width)
    torch.cuda.synchronize()
    on_cpu = pack_rows.pack_rows_plain(*cpu, pack_rows.ascii_table("cpu"), width)
    assert torch.equal(codes.cpu(), on_cpu)
    assert torch.equal(on_cpu, torch.from_numpy(want.codes))


@pytest.mark.card
def test_staging_flat_batches_does_not_synchronise(card):
    """A fresh ring stages and packs flat batches, its table copied
    included, and the plain version packs one, with no synchronising CUDA
    call (torch's sync debug mode raises on one); each batch is its padded
    batch."""
    reads = _reads(300, 0, 100, ODD_LETTERS, seed=12)
    flat = treads.flat_batches(reads, 128, 128)
    bases, starts, lengths = (torch.from_numpy(a.copy()).to(card)
                              for a in tstream._flat_host(flat[0])[:3])
    ring = tstream._PinnedRing(card, 2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        staged = [tstream._receive(ring(b)) for b in flat]
        plain = pack_rows.pack_rows_plain(bases, starts, lengths,
                                          pack_rows.ascii_table(card), 128)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for got, w in zip(staged, _padded(reads, 128, 128), strict=True):
        for x, y in zip(got, convert.read_batch_to_torch(w)):
            assert torch.equal(x.cpu(), y)
    assert torch.equal(plain, staged[0][0])


@pytest.mark.card
@pytest.mark.parametrize("outofcore_bytes", [3 << 30, 1 << 14], ids=["incore", "outofcore"])
def test_k0_launches_once_a_staged_batch(card, outofcore_bytes):
    """An assembly on the card packs once every batch it stages, which is
    its ``packed_batches``: each batch in core; the probe's and every pass's
    out of core.  The unitigs are the CPU's."""
    reads = _assembly_reads()
    cfg = PipelineConfig(k=21, m=7, parity=False, batch_reads=64, max_read_len=96,
                         outofcore_bytes=outofcore_bytes)
    got, stats = FastAssembler(cfg, device=card).unitigs(reads)
    packed = stats.counts["packed_batches"]
    n_batches = -(-len(reads) // 64)
    if outofcore_bytes == 3 << 30:
        assert packed == n_batches
    else:
        assert packed == 1 + stats.counts["passes"] * n_batches
    want, _ = FastAssembler(cfg, device="cpu").unitigs(reads)
    assert got == want

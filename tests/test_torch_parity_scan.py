"""Port vs JAX package: parity mode's ingest and scan (CPU).

The same numpy-seeded inputs go through the JAX functions and the port's:
the parity loaders of ``io/reads.py``, the encode functions parity mode
adds (``windowed_scores``, ``complement``, ``complement_packed``,
``decode_codes``, ``reverse_complement_u32``) and ``parity_scan`` at
(k, m) = (6, 3), (8, 4), (31, 4) and (31, 15) -- k = 2m and the widest
window included -- on batches with empty reads, reads shorter than k and
non-ACGT bytes.  The signature positions are held against the executable
spec ``parity/model.scan_read``.  Integers and strings only: tolerance 0.
The JAX scan leaves window slots that do not exist unspecified; the port
writes sentinels there, so JAX results are masked with ``valid`` by
``convert.window_records_from_lanes`` before comparing.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genome_assembly_tpu.io import reads as jreads
from genome_assembly_tpu.ops import encode as jencode
from genome_assembly_tpu.ops import minimizer as jmin
from genome_assembly_tpu.parity import model as jmodel
from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.common import MMER_SENTINEL, SENTINEL
from genome_assembly_tpu_torch.io import reads as treads
from genome_assembly_tpu_torch.ops import encode
from genome_assembly_tpu_torch.ops import minimizer as tmin
from genome_assembly_tpu_torch.parity import model as tmodel

KM = [(6, 3), (8, 4), (31, 4), (31, 15)]


def _reads(seed, n, max_len, dirty=True):
    """Random reads of length 0 .. max_len (empty and shorter than any k
    among them); with ``dirty``, some carry N, lowercase bases or 'X'."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n):
        r = "".join(rng.choice(list("ACGT"), size=int(rng.integers(0, max_len + 1))))
        if dirty and r and i % 5 == 1:
            pos = int(rng.integers(0, len(r)))
            bad = "NacgtX"[i % 6]
            r = r[:pos] + bad + r[pos + 1:]
        if dirty and i % 17 == 3:
            r = r.lower()
        reads.append(r)
    reads[0] = ""
    return reads


def _batch(reads, max_len):
    b = treads.batch_reads(reads, max_len, parity_chars=True)[0]
    return b.codes, b.lengths


def _assert_records(jax_recs, got):
    want = convert.window_records_from_lanes(
        np.asarray(jax_recs.mmer), np.asarray(jax_recs.kmer_hi),
        np.asarray(jax_recs.kmer_lo), np.asarray(jax_recs.valid))
    assert got.mmer.dtype == torch.int32 and got.kmer.dtype == torch.int64
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.mmer, want.mmer)
    assert torch.equal(got.kmer, want.kmer)
    assert bool((got.mmer[~got.valid] == MMER_SENTINEL).all())
    assert bool((got.kmer[~got.valid] == SENTINEL).all())


# -- loaders ---------------------------------------------------------------

def test_fgets_chunks_and_load_reads_parity_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    lines = ["".join(rng.choice(list("ACGT"), size=n)) for n in (100, 99, 101, 0, 200, 15, 250)]
    lines.append("ACGTNacgtX" * 3)
    path = tmp_path / "reads.txt"
    path.write_bytes(("\n".join(lines) + "\n").encode() + b"TTAG")  # last line unterminated
    data = path.read_bytes()
    for size in (101, 16, 2):
        assert list(treads.fgets_chunks(data, size)) == list(jreads.fgets_chunks(data, size))
        got = treads.load_reads_parity(str(path), size)
        assert got == jreads.load_reads_parity(str(path), size)
    reads = treads.load_reads_parity(str(path))
    # a 100-bp line: a 99-bp read and an empty one, each with its own id
    assert reads[0] == lines[0][:99] and reads[1] == ""


def test_validate_acgt_matches_jax():
    clean = ["ACGT", "", "TTTT"]
    treads.validate_acgt(clean)
    jreads.validate_acgt(clean)
    for bad in (["ACGT", "ACNT"], ["acgt"], ["ACGTX"]):
        with pytest.raises(ValueError) as theirs:
            jreads.validate_acgt(bad)
        with pytest.raises(ValueError) as ours:
            treads.validate_acgt(bad)
        assert str(ours.value) == str(theirs.value)


def test_batch_reads_parity_chars_matches_jax():
    reads = _reads(4, 50, 40)
    got = treads.batch_reads(reads, 48, 16, start_id=5, parity_chars=True)
    want = jreads.batch_reads(reads, 48, 16, start_id=5, parity_chars=True)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_array_equal(g.lengths, w.lengths)
        np.testing.assert_array_equal(g.read_ids, w.read_ids)
    # the reference table: lowercase and N score as 'A' (3), unlike fast mode
    lenient = treads.batch_reads(["acgN"], 8)[0].codes[0, :4]
    strict = treads.batch_reads(["acgN"], 8, parity_chars=True)[0].codes[0, :4]
    assert list(lenient) == [3, 2, 1, 3] and list(strict) == [3, 3, 3, 3]


# -- encode ----------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 3, 4, 15])
def test_windowed_scores_matches_jax(n):
    codes = np.random.default_rng(n).integers(0, 4, size=(6, 40), dtype=np.uint8)
    got = encode.windowed_scores(torch.from_numpy(codes), n)
    want = np.asarray(jencode.windowed_scores(jnp.asarray(codes), n))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    with pytest.raises(ValueError):
        encode.windowed_scores(torch.from_numpy(codes), 16)
    with pytest.raises(ValueError):
        encode.windowed_scores(torch.from_numpy(codes[:, :n - 1]), n)


def test_complement_and_decode_codes_match_jax():
    codes = np.random.default_rng(1).integers(0, 4, size=(5, 33), dtype=np.uint8)
    comp = encode.complement(torch.from_numpy(codes))
    assert comp.dtype == torch.uint8
    np.testing.assert_array_equal(comp.numpy(), np.asarray(jencode.complement(jnp.asarray(codes))))
    ascii_ = encode.decode_codes(torch.from_numpy(codes))
    np.testing.assert_array_equal(
        ascii_.numpy(), np.asarray(jencode.decode_codes(jnp.asarray(codes))))
    assert bytes(ascii_[0].tolist()).decode() == encode.decode_str(codes[0])


@pytest.mark.parametrize("k", [1, 6, 15, 16, 17, 31])
def test_complement_packed_matches_jax(k):
    codes = np.random.default_rng(k).integers(0, 4, size=(4, 40), dtype=np.uint8)
    key = encode.pack_kmers(torch.from_numpy(codes), k)
    got = encode.complement_packed(key, k)
    hi, lo = jencode.pack_kmers(jnp.asarray(codes), k)
    chi, clo = jencode.complement_packed(hi, lo, k)
    np.testing.assert_array_equal(got.numpy(), convert.lanes_to_key(chi, clo))
    # per-position complement, no reversal
    s = encode.unpack_int(int(key[0, 0]), k)
    assert encode.unpack_int(int(got[0, 0]), k) == tmodel.complement_str(s)


@pytest.mark.parametrize("n", [1, 4, 7, 15])
def test_reverse_complement_u32_matches_jax(n):
    v = np.random.default_rng(n).integers(0, 1 << (2 * n), size=64).astype(np.uint32)
    want = np.asarray(jencode.reverse_complement_u32(jnp.asarray(v), n))
    for dtype in (torch.int32, torch.int64):
        got = encode.reverse_complement_u32(torch.from_numpy(v.astype(np.int64)).to(dtype), n)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.numpy().astype(np.int64), want.astype(np.int64))


# -- the scan --------------------------------------------------------------

@pytest.mark.parametrize("k,m", KM)
def test_parity_scan_matches_jax(k, m):
    codes, lengths = _batch(_reads(k * 100 + m, 96, 64), 64)
    assert (lengths == 0).any() and ((lengths > 0) & (lengths < k)).any()
    got = tmin.parity_scan(torch.from_numpy(codes), torch.from_numpy(lengths), k=k, m=m)
    _assert_records(jmin.parity_scan(jnp.asarray(codes), jnp.asarray(lengths), k=k, m=m), got)
    assert int(got.valid.sum()) > 0


@pytest.mark.parametrize("k,m", [(6, 3), (31, 15)])
def test_parity_scan_one_window_and_all_empty(k, m):
    """L = k (one window a read) and a batch of empty reads only."""
    codes, lengths = _batch(_reads(9, 12, k, dirty=False), k)
    got = tmin.parity_scan(torch.from_numpy(codes), torch.from_numpy(lengths), k=k, m=m)
    assert got.kmer.shape == (12, 1)
    _assert_records(jmin.parity_scan(jnp.asarray(codes), jnp.asarray(lengths), k=k, m=m), got)
    empty = np.zeros((4, 40), np.uint8), np.zeros(4, np.int32)
    got = tmin.parity_scan(*map(torch.from_numpy, empty), k=k, m=m)
    assert not bool(got.valid.any())
    _assert_records(jmin.parity_scan(*map(jnp.asarray, empty), k=k, m=m), got)


def test_parity_scan_rejects_k_below_2m():
    codes = torch.zeros((2, 20), dtype=torch.uint8)
    with pytest.raises(ValueError):
        tmin.parity_scan(codes, torch.zeros(2, dtype=torch.int32), k=7, m=4)


@pytest.mark.parametrize("k,m", KM)
def test_signature_positions_and_strings_match_the_spec(k, m):
    """sig_pos, the stored signature and the stored k-mer of every valid
    window equal ``parity/model.scan_read`` (raw bytes of dirty reads
    scored by the reference table; the spec's strings, packed, are what
    the device holds).  The port's copy of the spec equals the JAX one."""
    reads = _reads(k + 7 * m, 40, 48)
    codes, lengths = _batch(reads, 48)
    t_codes = torch.from_numpy(codes)
    mask = (1 << (2 * m)) - 1
    fwd = encode.windowed_scores(t_codes, m)
    sig_pos = tmin._signature_positions(torch.maximum(fwd, mask - fwd), k, m)
    recs = tmin.parity_scan(t_codes, torch.from_numpy(lengths), k=k, m=m)
    n_checked = 0
    for rid, read in enumerate(reads):
        spec = tmodel.scan_read(read, rid, k, m)
        assert [dataclasses.astuple(r) for r in spec] == [
            dataclasses.astuple(r) for r in jmodel.scan_read(read, rid, k, m)]
        assert int(recs.valid[rid].sum()) == len(spec)
        for rec in spec:
            i = rec.window
            assert int(sig_pos[rid, i]) == rec.sig_pos
            assert int(recs.mmer[rid, i]) == encode.score_str(rec.signature)
            assert int(recs.kmer[rid, i]) == encode.score_str(rec.kmer)
            n_checked += 1
    assert n_checked > 100

"""Port vs JAX package: the canonical scan ``fast_scan`` (CPU).

The same numpy-seeded batch goes through the JAX ``minimizer.fast_scan``,
through the fused Pallas kernel in interpret mode (as tests/test_pallas.py
runs it on the CPU), and through the port's ``fast_scan`` -- which on a
CPU tensor is the plain version of the CUDA kernel.  Integers only:
tolerance 0.  The JAX scans leave window slots that do not exist
unspecified; the port writes sentinels there, so JAX results are masked
with ``valid`` by ``convert.window_records_from_lanes`` before comparing.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genome_assembly_tpu.ops import minimizer as jmin
from genome_assembly_tpu.ops.minimizer_pallas import fast_scan_pallas
from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.common import MMER_SENTINEL, SENTINEL
from genome_assembly_tpu_torch.ops import encode
from genome_assembly_tpu_torch.ops import minimizer as tmin


def _batch(seed, batch, max_len, min_len):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(batch, max_len), dtype=np.uint8)
    lengths = rng.integers(min_len, max_len + 1, size=(batch,)).astype(np.int32)
    codes[np.arange(max_len)[None, :] >= lengths[:, None]] = 0
    return codes, lengths


def _assert_same(jax_recs, got):
    want = convert.window_records_from_lanes(
        np.asarray(jax_recs.mmer), np.asarray(jax_recs.kmer_hi),
        np.asarray(jax_recs.kmer_lo), np.asarray(jax_recs.valid))
    assert got.mmer.dtype == torch.int32 and got.kmer.dtype == torch.int64
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.mmer, want.mmer)
    assert torch.equal(got.kmer, want.kmer)


@pytest.mark.parametrize("k,m", [(31, 7), (21, 7), (15, 5)])
def test_fast_scan_matches_jax_and_pallas_interpret(k, m):
    codes, lengths = _batch(0, 256, 128, k)
    got = tmin.fast_scan(torch.from_numpy(codes), torch.from_numpy(lengths), k=k, m=m)
    _assert_same(jmin.fast_scan(jnp.asarray(codes), jnp.asarray(lengths), k=k, m=m), got)
    _assert_same(
        fast_scan_pallas(jnp.asarray(codes), jnp.asarray(lengths), k=k, m=m, interpret=True),
        got,
    )


@pytest.mark.parametrize(
    "batch,max_len,k,m",
    [(100, 128, 31, 7), (37, 100, 21, 7), (5, 64, 17, 5), (5, 64, 16, 5),
     (3, 40, 31, 4), (1, 31, 31, 15), (7, 33, 7, 7)],
)
def test_fast_scan_awkward_shapes_match_jax(batch, max_len, k, m):
    """Batches that are no multiple of 256, reads shorter than k, empty reads."""
    codes, lengths = _batch(batch + k, batch, max_len, 0)
    got = tmin.fast_scan(torch.from_numpy(codes), torch.from_numpy(lengths), k=k, m=m)
    _assert_same(jmin.fast_scan(jnp.asarray(codes), jnp.asarray(lengths), k=k, m=m), got)
    # slots that do not exist hold the sentinels
    assert bool((got.kmer[~got.valid] == SENTINEL).all())
    assert bool((got.mmer[~got.valid] == MMER_SENTINEL).all())
    assert bool((got.kmer[got.valid] < (1 << (2 * k))).all())


def test_fast_scan_is_the_plain_version_on_cpu():
    codes, lengths = _batch(9, 16, 64, 0)
    a = tmin.fast_scan(torch.from_numpy(codes), torch.from_numpy(lengths), k=21, m=7)
    b = tmin.fast_scan_plain(torch.from_numpy(codes), torch.from_numpy(lengths), k=21, m=7)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_window_records_round_trip_through_convert():
    codes, lengths = _batch(4, 8, 48, 0)
    recs = tmin.fast_scan(torch.from_numpy(codes), torch.from_numpy(lengths), k=21, m=7)
    mmer, hi, lo, valid = convert.window_records_to_lanes(recs)
    assert mmer.dtype == hi.dtype == lo.dtype == np.uint32
    assert (mmer[~valid] == 0xFFFFFFFF).all() and (hi[~valid] == 0xFFFFFFFF).all()
    back = convert.window_records_from_lanes(mmer, hi, lo, valid)
    assert all(torch.equal(x, y) for x, y in zip(recs, back))


@pytest.mark.parametrize("k,m,max_len", [(32, 7, 64), (21, 16, 64), (5, 7, 64), (31, 7, 30)])
def test_fast_scan_rejects_bad_sizes(k, m, max_len):
    with pytest.raises(ValueError):
        tmin.fast_scan(torch.zeros((2, max_len), dtype=torch.uint8),
                       torch.zeros(2, dtype=torch.int32), k=k, m=m)


def _batch_of(kind, batch, max_len, seed):
    """Reads of a kind: "random" (lengths 0 .. L), "acgt" (ACGT repeated to
    full length: a window of even k at an even start equals its reverse
    complement), "empty" (every length 0)."""
    if kind == "acgt":
        codes = np.tile(np.arange(max_len, dtype=np.uint8) % 4, (batch, 1))
        return codes, np.full(batch, max_len, np.int32)
    codes, lengths = _batch(seed, batch, max_len, 0)
    if kind == "empty":
        return np.zeros_like(codes), np.zeros_like(lengths)
    return codes, lengths


@pytest.mark.parametrize("batch,max_len,k,m,kind", [
    (16, 31, 31, 7, "random"), (16, 7, 7, 3, "random"),          # L == k
    (16, 129, 31, 7, "random"), (16, 130, 21, 5, "random"),      # L % 4 == 1, 2, 3
    (16, 131, 31, 7, "random"),
    (16, 128, 31, 1, "random"), (16, 64, 5, 1, "random"),        # m == 1
    (16, 128, 15, 15, "random"), (16, 100, 7, 7, "random"),      # k == m
    (8, 128, 16, 5, "acgt"), (8, 128, 20, 7, "acgt"), (8, 130, 30, 15, "acgt"),
    (8, 128, 31, 7, "empty"),
])
def test_fast_scan_at_the_cards_check_shapes_matches_jax_and_pallas(batch, max_len, k, m, kind):
    """The shapes chip_smoke.py holds the kernel at against this plain
    version: so that check is a check against the JAX package too."""
    codes, lengths = _batch_of(kind, batch, max_len, batch + max_len + k)
    got = tmin.fast_scan(torch.from_numpy(codes), torch.from_numpy(lengths), k=k, m=m)
    _assert_same(jmin.fast_scan(jnp.asarray(codes), jnp.asarray(lengths), k=k, m=m), got)
    _assert_same(fast_scan_pallas(jnp.asarray(codes), jnp.asarray(lengths), k=k, m=m,
                                  block_rows=batch, interpret=True), got)
    if kind == "acgt":
        fwd, rc = encode.pack_kmers_both(torch.from_numpy(codes), k)
        assert bool((fwd == rc).any()) and bool((got.kmer == fwd)[fwd == rc].all())
    if kind == "empty":
        assert not bool(got.valid.any()) and bool((got.kmer == SENTINEL).all())


def test_fast_scan_of_the_longest_rows_matches_jax():
    """L = 8192, the kernel's limit, at a small batch."""
    codes, lengths = _batch(81, 2, 8192, 8000)
    got = tmin.fast_scan(torch.from_numpy(codes), torch.from_numpy(lengths), k=31, m=7)
    _assert_same(jmin.fast_scan(jnp.asarray(codes), jnp.asarray(lengths), k=31, m=7), got)
    assert int(got.valid.sum()) == int((lengths - 31 + 1).clip(0).sum())

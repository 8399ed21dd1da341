"""Port vs JAX package: 2-bit packing and reverse complements (CPU).

Inputs are made from a seed with numpy and go through both packages.
Everything here is integers: tolerance 0 (exact equality).  The port's
int64 key is compared with the JAX package's (hi, lo) uint32 lanes through
``convert.lanes_to_key`` / ``key_to_lanes``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genome_assembly_tpu.ops import encode as jenc
from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.ops import encode as tenc

KS = list(range(1, 32))


def _codes(seed, shape=(5, 47)):
    return np.random.default_rng(seed).integers(0, 4, size=shape, dtype=np.uint8)


@pytest.mark.parametrize("k", KS)
def test_pack_kmers_matches_jax(k):
    codes = _codes(k)
    hi, lo = jenc.pack_kmers(jnp.asarray(codes), k)
    got = tenc.pack_kmers(torch.from_numpy(codes), k)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), convert.lanes_to_key(np.asarray(hi), np.asarray(lo)))
    # and back: the key splits into the very lanes JAX holds
    ghi, glo = convert.key_to_lanes(got.numpy())
    assert np.array_equal(ghi, np.asarray(hi)) and np.array_equal(glo, np.asarray(lo))


@pytest.mark.parametrize("k", KS)
def test_pack_kmers_both_matches_jax(k):
    codes = _codes(100 + k)
    hi, lo, rhi, rlo = (np.asarray(x) for x in jenc.pack_kmers_both(jnp.asarray(codes), k))
    key, rc_key = tenc.pack_kmers_both(torch.from_numpy(codes), k)
    assert np.array_equal(key.numpy(), convert.lanes_to_key(hi, lo))
    assert np.array_equal(rc_key.numpy(), convert.lanes_to_key(rhi, rlo))


@pytest.mark.parametrize("k", KS)
def test_reverse_complement_packed_matches_jax(k):
    codes = _codes(200 + k)
    hi, lo = jenc.pack_kmers(jnp.asarray(codes), k)
    rhi, rlo = jenc.reverse_complement_packed(hi, lo, k)
    key = tenc.pack_kmers(torch.from_numpy(codes), k)
    got = tenc.reverse_complement_packed(key, k)
    assert np.array_equal(got.numpy(), convert.lanes_to_key(np.asarray(rhi), np.asarray(rlo)))
    # an involution, and equal to packing the reversed complement string
    assert torch.equal(tenc.reverse_complement_packed(got, k), key)
    s = tenc.decode_str(codes[0, :k])
    rc = s.translate(str.maketrans("ACGT", "TGCA"))[::-1]
    assert int(got[0, 0]) == tenc.pack_str(rc)


@pytest.mark.parametrize("m", [1, 4, 5, 7, 15])
def test_windowed_pyramids_match_jax(m):
    codes = _codes(300 + m)
    n = codes.shape[1] - m + 1
    jf = jenc._windowed_pack(jenc._doubling_packs(jnp.asarray(codes), m), m, n)
    jr = jenc._windowed_rc_pack(jenc._doubling_rc_packs(jnp.asarray(codes), m), m, n)
    t = torch.from_numpy(codes)
    tf = tenc._windowed_pack(tenc._doubling_packs(t, m), m, n)
    tr = tenc._windowed_rc_pack(tenc._doubling_rc_packs(t, m), m, n)
    assert np.array_equal(tf.numpy(), np.asarray(jf).astype(np.int64))
    assert np.array_equal(tr.numpy(), np.asarray(jr).astype(np.int64))


def test_encode_bytes_and_tables_match_jax():
    raw = np.arange(256, dtype=np.uint8)
    want = np.asarray(jenc.encode_bytes(jnp.asarray(raw)))
    assert np.array_equal(tenc.encode_bytes(torch.from_numpy(raw)).numpy(), want)
    assert np.array_equal(tenc._ASCII_TO_CODE, jenc._ASCII_TO_CODE)
    assert np.array_equal(tenc._ASCII_TO_CODE_REF, jenc._ASCII_TO_CODE_REF)


@pytest.mark.parametrize("s", ["ACGT", "ttgacNNa", "GATTACA" * 4 + "GAT"])
def test_host_helpers_match_jax(s):
    assert np.array_equal(tenc.encode_str(s), jenc.encode_str(s))
    assert np.array_equal(tenc.encode_str_parity(s), jenc.encode_str_parity(s))
    assert tenc.score_str(s) == jenc.score_str(s) == tenc.pack_str(s)
    k = len(s)
    v = tenc.pack_str(s)
    assert tenc.unpack_int(v, k) == jenc.unpack_int(v, k)
    assert tenc.int_to_split(v, k) == jenc.int_to_split(v, k)
    hi, lo = tenc.int_to_split(v, k)
    assert tenc.split_to_int(hi, lo, k) == v
    assert tenc.decode_str(tenc.encode_str(s)) == jenc.decode_str(jenc.encode_str(s))


@pytest.mark.parametrize("k", [0, 32])
def test_pack_kmers_rejects_bad_k(k):
    with pytest.raises(ValueError):
        tenc.pack_kmers(torch.zeros((1, 40), dtype=torch.uint8), k)


def test_sentinels_map_both_ways():
    hi = np.array([0, 0xFFFFFFFF, 5], dtype=np.uint32)
    lo = np.array([7, 0xFFFFFFFF, 0xFFFFFFFF], dtype=np.uint32)
    key = convert.lanes_to_key(hi, lo)
    assert key[1] == torch.iinfo(torch.int64).max
    assert key[0] == 7 and key[2] == (5 << 32) | 0xFFFFFFFF
    bhi, blo = convert.key_to_lanes(key)
    assert np.array_equal(bhi, hi) and np.array_equal(blo, lo)

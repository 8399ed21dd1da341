"""Port vs JAX package: the bitonic sorting network, pass by pass and whole (CPU).

The same int64 keys, made from a seed with numpy (duplicates, sentinels,
non-power-of-two lengths), go through each plain pass of
``genome_assembly_tpu_torch/ops/bitonic_sort.py`` and through the Pallas pass
it stands for, run in interpret mode; ``convert`` maps the int64 key to the
JAX (hi, lo) lanes and back.  Equal keys are indistinguishable, so every pass
of the network is a fixed function of its input: every comparison is
bit-exact (tolerance 0), pass by pass and for the composed sorts.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from genome_assembly_tpu.ops import bitonic_pallas as bp
from genome_assembly_tpu.ops.sort_pallas import sort_rows_pallas
from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.common import SENTINEL
from genome_assembly_tpu_torch.ops import bitonic_sort as bs


def _keys(seed, shape):
    """Keys < 2^62 with repeated values and a few sentinels at the front."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 1 << 62, size=shape, dtype=np.int64)
    flat = key.reshape(-1)
    flat[::5] = flat[0]
    flat[::11] = flat[1]
    flat[:3] = SENTINEL
    return key


def _lanes2d(key, width):
    hi, lo = convert.key_to_lanes(key)
    return jnp.asarray(hi.reshape(-1, width)), jnp.asarray(lo.reshape(-1, width))


def _flat_key(hi, lo):
    return convert.lanes_to_key(np.asarray(hi).reshape(-1), np.asarray(lo).reshape(-1))


# --------------------------------------------------------------------------
# (a) every plain pass against its Pallas pass
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rows,c", [(8, 256), (16, 1024), (8, 512), (8, 2), (24, 8)])
def test_sort_rows_plain_matches_pallas(rows, c):
    key = _keys(1, (rows, c))
    hi, lo = convert.key_to_lanes(key)
    jhi, jlo = sort_rows_pallas(jnp.asarray(hi), jnp.asarray(lo), interpret=True)
    want = convert.lanes_to_key(np.asarray(jhi), np.asarray(jlo))
    got = bs.sort_rows(torch.from_numpy(key)).numpy()
    assert got.shape == (rows, c)
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.sort(key, axis=1))


@pytest.mark.parametrize("n,cr,w,sizes", [
    (256, 4, 8, None),
    (4096, 8, 16, None),
    (1024, 4, 8, None),
    (1024, 4, 8, [64]),           # one level above the chunk: what finish does
    (1024, 4, 8, [2, 8, 128]),    # any ascending subset of levels
    (512, 4, 8, [512]),           # size == total: every pair ascends
])
def test_chunk_sort_plain_matches_pallas(n, cr, w, sizes):
    chunk = cr * w
    if sizes is None:
        sizes = [1 << b for b in range(1, chunk.bit_length())]
    key = _keys(2, n)
    jhi, jlo = bp._run_chunk_pass(*_lanes2d(key, w), sizes, chunk_rows=cr, width=w,
                                  interpret=True)
    got = bs.chunk_sort(torch.from_numpy(key), sizes, chunk=chunk).numpy()
    assert np.array_equal(got, _flat_key(jhi, jlo))


@pytest.mark.parametrize("n,w,d,size", [
    (4096, 16, 128, 256),      # the first big stage of the first level
    (4096, 16, 2048, 4096),    # the largest distance; size == total
    (4096, 16, 512, 4096),
    (4096, 16, 512, 1024),
    (256, 8, 8, 64),           # one row a block
    (3072, 16, 256, 1024),     # total not a power of two: whole blocks of 2 d
])
def test_big_ce_plain_matches_pallas(n, w, d, size):
    key = _keys(3, n)
    jhi, jlo = bp._run_big_ce(*_lanes2d(key, w), d, size, width=w, interpret=True)
    got = bs.big_ce(torch.from_numpy(key), d, size).numpy()
    assert np.array_equal(got, _flat_key(jhi, jlo))


@pytest.mark.parametrize("n,cr,w,size", [
    (256, 4, 8, 64),
    (256, 4, 8, 256),      # size == total
    (4096, 8, 16, 1024),
    (4096, 8, 16, 4096),
    (1024, 4, 8, 32),      # size == chunk: the chunk's own last level
])
def test_finish_plain_matches_pallas(n, cr, w, size):
    key = _keys(4, n)
    jhi, jlo = bp._run_finish(*_lanes2d(key, w), size, chunk_rows=cr, width=w,
                              interpret=True)
    got = bs.finish(torch.from_numpy(key), size, chunk=cr * w).numpy()
    assert np.array_equal(got, _flat_key(jhi, jlo))


@pytest.mark.parametrize("kind", ["all_equal", "sorted", "reversed", "sentinels_only"])
def test_passes_on_degenerate_inputs_match_pallas(kind):
    n, cr, w = 512, 4, 8
    chunk = cr * w
    base = np.sort(_keys(5, n))
    key = {"all_equal": np.full(n, 12345, np.int64), "sorted": base,
           "reversed": base[::-1].copy(),
           "sentinels_only": np.full(n, SENTINEL, np.int64)}[kind]
    sizes = [1 << b for b in range(1, chunk.bit_length())]
    t = torch.from_numpy(key)
    j = _lanes2d(key, w)
    assert np.array_equal(
        bs.chunk_sort(t, sizes, chunk=chunk).numpy(),
        _flat_key(*bp._run_chunk_pass(*j, sizes, chunk_rows=cr, width=w, interpret=True)))
    assert np.array_equal(
        bs.big_ce(t, 64, 128).numpy(),
        _flat_key(*bp._run_big_ce(*j, 64, 128, width=w, interpret=True)))
    assert np.array_equal(
        bs.finish(t, 128, chunk=chunk).numpy(),
        _flat_key(*bp._run_finish(*j, 128, chunk_rows=cr, width=w, interpret=True)))
    assert np.array_equal(bs.sort_keys(t, chunk=chunk).numpy(), np.sort(key))


# --------------------------------------------------------------------------
# (b) the composed sorts, at the parameters of tests/test_pallas.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,cr,w", [(256, 4, 8), (4096, 8, 16), (1000, 4, 8)])
def test_sort_keys_matches_sort_pairs(n, cr, w):
    key = _keys(6, n)
    hi, lo = convert.key_to_lanes(key)
    jhi, jlo = bp.sort_pairs(jnp.asarray(hi), jnp.asarray(lo), chunk_rows=cr, width=w,
                             interpret=True)
    t = torch.from_numpy(key.copy())
    got = bs.sort_keys(t, chunk=cr * w).numpy()
    assert np.array_equal(got, _flat_key(jhi, jlo))
    assert np.array_equal(got, np.sort(key))
    assert np.array_equal(t.numpy(), key)  # the caller's tensor is untouched


@pytest.mark.parametrize("n,xc,cr,w", [(4096, 256, 4, 16), (3000, 256, 4, 16),
                                       (1025, 128, 4, 8)])
def test_sort_keys_hybrid_matches_sort_pairs_hybrid(n, xc, cr, w):
    key = _keys(7, n)
    hi, lo = convert.key_to_lanes(key)
    jhi, jlo = bp.sort_pairs_hybrid(jnp.asarray(hi), jnp.asarray(lo), xla_chunk=xc,
                                    chunk_rows=cr, width=w, interpret=True)
    t = torch.from_numpy(key.copy())
    got = bs.sort_keys_hybrid(t, lib_chunk=xc, chunk=cr * w).numpy()
    assert np.array_equal(got, _flat_key(jhi, jlo))
    assert np.array_equal(got, np.sort(key))
    assert np.array_equal(t.numpy(), key)


def test_sentinel_lanes_sort_last_as_int64_max():
    """The all-ones lane pair must become int64 max (not -1) to sort last."""
    hi = np.array([0xFFFFFFFF, 5, 0], np.uint32)
    lo = np.array([0xFFFFFFFF, 7, 1], np.uint32)
    key = convert.lanes_to_key(hi, lo)
    assert key[0] == SENTINEL
    got = bs.sort_keys_hybrid(torch.from_numpy(np.tile(key, 100)), lib_chunk=8, chunk=4)
    assert got[-100:].tolist() == [SENTINEL] * 100


# --------------------------------------------------------------------------
# (c) the fallback thresholds: both packages take the same branch
# --------------------------------------------------------------------------

def _count_calls(monkeypatch, name):
    calls = []
    real = getattr(bs, name)

    def counting(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(bs, name, counting)
    return calls


def _jax_runs_kernels(fn, n, **kw):
    hi = jnp.zeros((n,), jnp.uint32)
    text = str(jax.make_jaxpr(lambda a, b: fn(a, b, interpret=True, **kw))(hi, hi))
    return "pallas_call" in text


@pytest.mark.parametrize("n,network", [(1, False), (63, False), (64, True), (65, True)])
def test_sort_keys_threshold_matches_jax(monkeypatch, n, network):
    calls = _count_calls(monkeypatch, "chunk_sort_plain")
    key = _keys(8, max(n, 3))[:n]
    got = bs.sort_keys(torch.from_numpy(key), chunk=32)
    assert np.array_equal(got.numpy(), np.sort(key))
    assert bool(calls) == network
    assert _jax_runs_kernels(bp.sort_pairs, n, chunk_rows=4, width=8) == network


@pytest.mark.parametrize("n,network", [(1, False), (128, False), (129, True), (256, True)])
def test_sort_keys_hybrid_threshold_matches_jax(monkeypatch, n, network):
    calls = _count_calls(monkeypatch, "finish_plain")
    key = _keys(9, max(n, 3))[:n]
    got = bs.sort_keys_hybrid(torch.from_numpy(key), lib_chunk=64, chunk=32)
    assert np.array_equal(got.numpy(), np.sort(key))
    assert bool(calls) == network
    assert _jax_runs_kernels(bp.sort_pairs_hybrid, n, xla_chunk=64, chunk_rows=4,
                             width=8) == network


def test_pass_counts_of_the_hybrid(monkeypatch):
    """n = 1000, lib_chunk 64, chunk 16: pads to 1024; levels 128 .. 1024 have
    log2(size / 16) big stages each and one finish."""
    big = _count_calls(monkeypatch, "big_ce_plain")
    fin = _count_calls(monkeypatch, "finish_plain")
    chunk = _count_calls(monkeypatch, "chunk_sort_plain")
    key = _keys(10, 1000)
    got = bs.sort_keys_hybrid(torch.from_numpy(key), lib_chunk=64, chunk=16)
    assert np.array_equal(got.numpy(), np.sort(key))
    assert (len(big), len(fin), len(chunk)) == (3 + 4 + 5 + 6, 4, 0)


def test_defaults_are_read_at_call_time(monkeypatch):
    calls = _count_calls(monkeypatch, "big_ce_plain")
    key = torch.from_numpy(_keys(11, 700))
    assert torch.equal(bs.sort_keys_hybrid(key), torch.sort(key).values)
    assert not calls  # 700 keys are far below two default library chunks
    monkeypatch.setattr(bs, "DEFAULT_LIB_CHUNK", 64)
    monkeypatch.setattr(bs, "DEFAULT_CHUNK", 16)
    assert torch.equal(bs.sort_keys_hybrid(key), torch.sort(key).values)
    assert torch.equal(bs.sort_keys(key), torch.sort(key).values)
    assert calls


# --------------------------------------------------------------------------
# what the functions refuse
# --------------------------------------------------------------------------

_K = torch.zeros(64, dtype=torch.int64)


@pytest.mark.parametrize("call,exc", [
    (lambda: bs.sort_rows(torch.zeros((4, 6), dtype=torch.int64)), ValueError),
    (lambda: bs.sort_rows(torch.zeros((4, 1), dtype=torch.int64)), ValueError),
    (lambda: bs.sort_rows(_K), ValueError),
    (lambda: bs.sort_rows(torch.zeros((4, 8), dtype=torch.int32)), TypeError),
    (lambda: bs.chunk_sort(_K, [2, 4], chunk=6), ValueError),
    (lambda: bs.chunk_sort(_K, [2, 4], chunk=128), ValueError),
    (lambda: bs.chunk_sort(_K, [4, 2], chunk=8), ValueError),
    (lambda: bs.chunk_sort(_K, [2, 6], chunk=8), ValueError),
    (lambda: bs.chunk_sort(_K, [1, 2], chunk=8), ValueError),
    (lambda: bs.chunk_sort(_K.int(), [2], chunk=8), TypeError),
    (lambda: bs.big_ce(_K, 3, 8), ValueError),
    (lambda: bs.big_ce(_K, 8, 8), ValueError),
    (lambda: bs.big_ce(_K, 64, 128), ValueError),
    (lambda: bs.big_ce(_K.int(), 8, 16), TypeError),
    (lambda: bs.finish(_K, 4, chunk=8), ValueError),
    (lambda: bs.finish(_K, 24, chunk=8), ValueError),
    (lambda: bs.finish(_K, 16, chunk=12), ValueError),
    (lambda: bs.sort_keys(_K, chunk=12), ValueError),
    (lambda: bs.sort_keys(_K.int(), chunk=8), TypeError),
    (lambda: bs.sort_keys(_K.view(8, 8), chunk=8), TypeError),
    (lambda: bs.sort_keys_hybrid(_K, lib_chunk=8, chunk=16), ValueError),
    (lambda: bs.sort_keys_hybrid(_K, lib_chunk=12, chunk=4), ValueError),
])
def test_bad_arguments_are_refused(call, exc):
    with pytest.raises(exc):
        call()


def test_hybrid_refuses_chunk_that_does_not_divide_like_jax():
    hi = jnp.zeros((4096,), jnp.uint32)
    with pytest.raises(ValueError):
        bp.sort_pairs_hybrid(hi, hi, xla_chunk=64, chunk_rows=8, width=16, interpret=True)
    with pytest.raises(ValueError):
        bs.sort_keys_hybrid(torch.zeros(4096, dtype=torch.int64), lib_chunk=64, chunk=128)


# --------------------------------------------------------------------------
# (d) property: any keys, any valid chunk sizes
# --------------------------------------------------------------------------

_key_lists = st.lists(
    st.one_of(st.integers(0, (1 << 62) - 1), st.integers(0, 7), st.just(SENTINEL)),
    min_size=0, max_size=700)


@settings(max_examples=60, deadline=None, database=None)
@given(keys=_key_lists, log_chunk=st.integers(1, 6), log_ratio=st.integers(0, 3))
def test_sorts_equal_numpy_sort_for_any_keys_and_chunks(keys, log_chunk, log_ratio):
    key = np.array(keys, dtype=np.int64)
    chunk = 1 << log_chunk
    lib_chunk = chunk << log_ratio
    want = np.sort(key)
    t = torch.from_numpy(key)
    assert np.array_equal(bs.sort_keys(t, chunk=chunk).numpy(), want)
    assert np.array_equal(bs.sort_keys_hybrid(t, lib_chunk=lib_chunk, chunk=chunk).numpy(), want)


@settings(max_examples=30, deadline=None, database=None)
@given(rows=st.integers(1, 5), log_c=st.integers(1, 7), seed=st.integers(0, 2**31))
def test_sort_rows_equals_numpy_sort_for_any_shape(rows, log_c, seed):
    key = _keys(seed, (rows, 1 << log_c))
    assert np.array_equal(bs.sort_rows(torch.from_numpy(key)).numpy(), np.sort(key, axis=1))

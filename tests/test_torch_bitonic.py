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
from genome_assembly_tpu_torch.ops import bitonic_cuda as bc
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
# the prefix rule: the levels 2, 4 .. s of the network sort every run of s
# keys, ascending or descending by the run's global position.  On the card
# chunk_sort computes such a list with a merge sort and a reversed store; this
# pins on the CPU that a sort plus reversal is the network's output.
# --------------------------------------------------------------------------

def _levels(top):
    return [1 << b for b in range(1, top.bit_length())]


def _sorted_runs_alternating(key, s):
    """Every run of s keys sorted; the runs whose global start p has
    (p & s) != 0 flipped to descending."""
    runs = torch.sort(key.view(-1, s), dim=1).values
    down = (torch.arange(0, key.shape[0], s) & s) != 0
    runs[down] = runs[down].flip(1)
    return runs.reshape(-1)


def _pattern(kind, n, seed):
    base = np.sort(_keys(seed, n))
    return {"random": _keys(seed, n), "all_equal": np.full(n, 12345, np.int64), "sorted": base,
            "reversed": base[::-1].copy(),
            "sentinels_only": np.full(n, SENTINEL, np.int64)}[kind]


_PATTERNS = ["random", "all_equal", "sorted", "reversed", "sentinels_only"]
_PREFIXES = [(chunk, s) for chunk in (2, 8, 32, 128) for s in _levels(chunk)]


@pytest.mark.parametrize("kind", _PATTERNS)
@pytest.mark.parametrize("chunk,s", _PREFIXES)
def test_prefix_levels_sort_every_run_with_alternating_direction(chunk, s, kind):
    for n_chunks in (1, 5, 8):  # an odd and an even number of chunks
        key = torch.from_numpy(_pattern(kind, n_chunks * chunk, 12 + s))
        assert bs.prefix_top(_levels(s), chunk) == s
        got = bs.chunk_sort_plain(key, _levels(s), chunk=chunk)
        assert torch.equal(got, _sorted_runs_alternating(key, s))


@pytest.mark.parametrize("s", [8, 32])
def test_prefix_rule_matches_pallas_chunk_pass(s):
    n, cr, w = 1024, 4, 8
    key = _keys(13, n)
    jhi, jlo = bp._run_chunk_pass(*_lanes2d(key, w), _levels(s), chunk_rows=cr, width=w,
                                  interpret=True)
    want = _sorted_runs_alternating(torch.from_numpy(key), s).numpy()
    assert np.array_equal(_flat_key(jhi, jlo), want)


@settings(max_examples=40, deadline=None, database=None)
@given(log_s=st.integers(1, 6), log_more=st.integers(0, 2), n_chunks=st.integers(1, 7),
       seed=st.integers(0, 2**31))
def test_prefix_rule_for_any_keys_and_chunks(log_s, log_more, n_chunks, seed):
    s, chunk = 1 << log_s, 1 << (log_s + log_more)
    key = torch.from_numpy(_keys(seed, n_chunks * chunk))
    assert torch.equal(bs.chunk_sort(key, _levels(s), chunk=chunk),
                       _sorted_runs_alternating(key, s))


# --------------------------------------------------------------------------
# what the card's wrappers decide from their arguments alone: whether a list
# of levels is a sort, and the thread block of the two merge sorts
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sizes,chunk,top", [
    ([2], 2, 2), ([2], 64, 2), ([2, 4, 8], 8, 8), ([2, 4, 8], 64, 8),
    (_levels(1 << 14), 1 << 14, 1 << 14), (tuple(_levels(32)), 32, 32),
    ([], 8, 0),                    # no level: nothing to sort
    ([2, 4, 8], 4, 0),             # the last level is above the chunk: partial
    ([4], 8, 0), ([2, 8], 8, 0), ([4, 8], 8, 0),      # a level is missing
    ([16], 8, 0), ([2, 8, 1 << 40], 8, 0), ([2, 4, 8, 16], 8, 0),
])
def test_prefix_top_names_the_complete_prefixes_only(sizes, chunk, top):
    assert bs.prefix_top(sizes, chunk) == top


_SHARED_BYTES_A_BLOCK = 232448  # what a thread block of the card may use


@pytest.mark.parametrize("wanted_block_keys", [2, 2048, 4096, 1 << 14])
@pytest.mark.parametrize("log_run", range(1, 15))
def test_block_shape_fits_the_card_for_every_run(monkeypatch, log_run, wanted_block_keys):
    """Every row length of sort_rows and every last level of chunk_sort, 2 ..
    2^14, with any least block: whole runs a block, the keys a thread the
    kernels are compiled for, at most 1024 threads, at most the shared memory
    a block may use."""
    monkeypatch.setattr(bc, "BLOCK_KEYS", wanted_block_keys)
    run = 1 << log_run
    block_keys, threads, shared_bytes = bc.block_shape(run)
    assert block_keys >= max(run, wanted_block_keys) and block_keys % run == 0
    assert block_keys & (block_keys - 1) == 0 and block_keys <= bc.MAX_SHARED_KEYS
    assert threads * bc.KEYS_PER_THREAD == block_keys and 1 <= threads <= 1024
    assert 8 * block_keys < shared_bytes <= _SHARED_BYTES_A_BLOCK


@pytest.mark.parametrize("log_chunk", range(1, 15))
def test_block_shape_of_a_chunk_sort_follows_its_last_level(log_chunk):
    """chunk_sort(levels 2 .. s, chunk): the block holds whole runs of s keys,
    whatever the chunk; with the defaults a block of at least 4096 keys."""
    chunk = 1 << log_chunk
    for s in _levels(chunk):
        top = bs.check_prefix(_levels(s), chunk)
        block_keys, threads, shared_bytes = bc.block_shape(top)
        assert top == s and block_keys == max(s, bc.BLOCK_KEYS) and block_keys % s == 0
        assert threads <= 1024 and shared_bytes <= _SHARED_BYTES_A_BLOCK


@pytest.mark.parametrize("sizes,chunk", [
    ([], 8), ([2, 4, 8], 4), ([4], 8), ([2, 8], 8), ([4, 8], 8), ([16], 8),
    ([2, 8, 1 << 40], 8), ([2, 4, 8, 16], 8), ([1 << 15], 1 << 14),
])
def test_the_card_refuses_a_partial_list_of_levels(sizes, chunk):
    """A list that is no complete prefix is a partial network: the plain
    version runs it (as the JAX chunk pass does), the card's wrapper does not."""
    with pytest.raises(ValueError):
        bs.check_prefix(sizes, chunk)
    key = torch.from_numpy(_keys(15, 4 * chunk))
    assert bs.chunk_sort(key, sizes, chunk=chunk).shape == key.shape  # the CPU takes it


def test_dispatcher_sends_cpu_keys_to_the_plain_version_for_any_list(monkeypatch):
    calls = _count_calls(monkeypatch, "chunk_sort_plain")
    key = torch.from_numpy(_keys(14, 256))
    assert torch.equal(bs.chunk_sort(key, _levels(32), chunk=32),
                       _sorted_runs_alternating(key, 32))
    bs.chunk_sort(key, [64], chunk=32)
    assert len(calls) == 2 and set(bc.launch_count.values()) == {0}


# --------------------------------------------------------------------------
# finish on the card: the stages of a level in register groups
# (``finish_shape``); the layout the kernel computes, modelled here, is the
# same compare-exchanges as finish_plain in another order
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,cr,w,size", [
    (512, 2, 8, 16),       # size == chunk: the direction alternates chunk by chunk
    (512, 4, 8, 64),       # size > chunk
    (2048, 8, 16, 256),
    (2048, 8, 16, 1 << 30),
])
def test_finish_plain_matches_pallas_on_keys_in_no_bitonic_order(n, cr, w, size):
    key = _keys(16, n)
    chunk = cr * w
    halves = key.reshape(-1, chunk // 2)
    assert not all((np.diff(h) >= 0).all() or (np.diff(h) <= 0).all() for h in halves)
    jhi, jlo = bp._run_finish(*_lanes2d(key, w), size, chunk_rows=cr, width=w, interpret=True)
    got = bs.finish_plain(torch.from_numpy(key), size, chunk=chunk).numpy()
    assert np.array_equal(got, _flat_key(jhi, jlo))


@pytest.mark.parametrize("per_thread", [16, 32])
@pytest.mark.parametrize("log_chunk", range(1, 15))
def test_finish_shape_runs_every_stage_once_in_order(monkeypatch, per_thread, log_chunk):
    monkeypatch.setattr(bc, "FINISH_KEYS_PER_THREAD", per_thread)
    chunk = 1 << log_chunk
    threads, keys, groups, shared_bytes = bc.finish_shape(chunk)
    assert threads * keys == chunk and keys == min(per_thread, chunk)
    assert 1 <= threads <= 1024
    assert [b for group in groups for b in group] == list(range(log_chunk - 1, -1, -1))
    g = keys.bit_length() - 1
    assert all(len(group) == g for group in groups[:-1]) and 1 <= len(groups[-1]) <= g
    assert len(groups) - 1 == -(-log_chunk // g) - 1  # shared-memory exchanges
    assert shared_bytes <= _SHARED_BYTES_A_BLOCK
    assert shared_bytes == (0 if len(groups) == 1 else (chunk + chunk // 16 + 1) * 8)


def _finish_in_register_groups(key, size, chunk):
    """finish as the kernel runs it: per group of stage bits, thread t holds
    the keys at (t's bits below lo) | j << lo | (t's other bits) << (lo + g)
    and compare-exchanges them among themselves; a descending chunk is sorted
    as the complement of its keys."""
    threads, per_thread, groups, _ = bc.finish_shape(chunk)
    g = per_thread.bit_length() - 1
    out = key.copy()
    for base in range(0, key.shape[0], chunk):
        x = out[base:base + chunk] ^ (0 if base & size == 0 else -1)
        for group in groups:
            lo = max(0, group[0] - g + 1)
            held = []
            for t in range(threads):
                at = (t & ((1 << lo) - 1)) | ((t >> lo) << (lo + g))
                idx = [at | (j << lo) for j in range(per_thread)]
                held += idx
                r = x[idx]
                for b in group:
                    for j in range(per_thread):
                        if not j >> (b - lo) & 1:
                            p = j | 1 << (b - lo)
                            r[j], r[p] = min(r[j], r[p]), max(r[j], r[p])
                x[idx] = r
            assert sorted(held) == list(range(chunk))  # every key held by one thread once
        out[base:base + chunk] = x ^ (0 if base & size == 0 else -1)
    return out


@pytest.mark.parametrize("per_thread", [16, 32])
@pytest.mark.parametrize("chunk,size", [(2, 2), (8, 16), (16, 16), (32, 32), (64, 256),
                                        (128, 128), (512, 1 << 40), (1024, 2048)])
def test_register_groups_equal_the_stage_by_stage_network(monkeypatch, per_thread, chunk, size):
    monkeypatch.setattr(bc, "FINISH_KEYS_PER_THREAD", per_thread)
    key = _keys(17 + chunk, 5 * chunk)
    want = bs.finish_plain(torch.from_numpy(key), size, chunk=chunk).numpy()
    assert np.array_equal(_finish_in_register_groups(key, size, chunk), want)


@pytest.mark.parametrize("call,exc", [
    (lambda: bc.finish_cuda(_K_CPU, 16, chunk=8, threads=1024), TypeError),
    (lambda: bc.finish_cuda(_K_CPU, 16, chunk=8), ValueError),
    (lambda: bc.finish_cuda(_K_CPU, 16, 8), TypeError),
    (lambda: bc.finish_cuda(_K_CPU.int(), 16, chunk=8), ValueError),
])
def test_finish_cuda_takes_no_threads_and_refuses_the_cpu(call, exc):
    with pytest.raises(exc):
        call()
    assert set(bc.launch_count.values()) == {0} and not hasattr(bc, "SHARED_THREADS")


_K_CPU = torch.zeros(64, dtype=torch.int64)


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
    (lambda: bs.chunk_sort(_K, [2, 2], chunk=8), ValueError),
    (lambda: bs.chunk_sort(_K, [0], chunk=8), ValueError),
    (lambda: bs.chunk_sort(_K, [2, 1 << 63], chunk=8), ValueError),
    (lambda: bs.chunk_sort(_K.view(8, 8), [2, 4, 8], chunk=8), ValueError),
    (lambda: bs.chunk_sort(_K[:60], [2, 4, 8], chunk=8), ValueError),
    (lambda: bc.sort_rows_cuda(_K.view(8, 8)), ValueError),
    (lambda: bc.chunk_sort_cuda(_K, [2, 4, 8], chunk=8), ValueError),
    (lambda: bc.chunk_sort_cuda(_K, [16], chunk=8), ValueError),
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

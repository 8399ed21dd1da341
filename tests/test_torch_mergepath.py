"""Port vs JAX package: the merge-path sort, pass by pass and whole (CPU).

The same int64 keys, made from a seed with numpy (duplicates, sentinels,
non-power-of-two lengths), go through ``merge_splits_plain`` (and the
``merge_splits`` dispatcher, which on a CPU tensor is the same), each plain pass
and the composed sort of ``genome_assembly_tpu_torch/ops/mergepath_sort.py`` and
through their counterparts of ``genome_assembly_tpu/ops/mergepath_pallas.py``,
the Pallas passes run in interpret mode; ``convert`` maps the int64 key to the
JAX (hi, lo) lanes and back.  The JAX passes work on a ``[rows, width]`` layout
with pad rows behind the real ones; the port's are flat, so the real rows are
what is compared.  Equal keys are indistinguishable and every pass is a fixed
function of its input: every comparison is bit-exact (tolerance 0).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from genome_assembly_tpu.ops import mergepath_pallas as mp
from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.common import SENTINEL
from genome_assembly_tpu_torch.ops import mergepath_sort as ms

# (n, tile, width, base_run, chunk): the configurations of tests/test_mergepath.py
CONFIGS = [
    (4096, 512, 128, 128, 1024),
    (5000, 512, 128, 128, 1024),      # sentinel-padded
    (16384, 512, 128, 256, 2048),
    (65536, 2048, 256, 512, 8192),
    (65536, 2048, 256, 2048, 2048),   # base_run == chunk: no local levels
    (8192, 512, 128, 128, 2048),      # chunk == total / 4
]


def _keys(seed, n):
    """Keys < 2^62 with repeated values and a few sentinels at the front."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 1 << 62, size=n, dtype=np.int64)
    key[::7] = key[0]
    key[::13] = key[3]
    key[:3] = SENTINEL
    return key


def _padded(key):
    """key padded with SENTINEL to the next power of two, as the sorts pad."""
    total = 1 << (len(key) - 1).bit_length()
    return np.concatenate([key, np.full(total - len(key), SENTINEL, np.int64)])


def _runs(key, run):
    """The sort's state before a pass that expects ascending runs of ``run``."""
    return np.sort(_padded(key).reshape(-1, run), axis=1).reshape(-1)


def _jax_layout(key, width, tile):
    """(hi, lo) as the JAX passes take them: [real_rows + tile/width + 8, width]."""
    hi, lo = convert.key_to_lanes(key)
    pad = np.full((tile // width + 8, width), 0xFFFFFFFF, np.uint32)
    return (jnp.asarray(np.concatenate([hi.reshape(-1, width), pad])),
            jnp.asarray(np.concatenate([lo.reshape(-1, width), pad])))


def _real_rows(hi, lo, n):
    return convert.lanes_to_key(np.asarray(hi).reshape(-1)[:n], np.asarray(lo).reshape(-1)[:n])


def _levels(base_run, chunk):
    return [1 << b for b in range(base_run.bit_length(), chunk.bit_length())]


def _merge_runs(chunk, total):
    return [chunk << i for i in range((total // chunk).bit_length() - 1)]


def _jax_splits(key, run, tile):
    hi, lo = convert.key_to_lanes(key)
    return [np.asarray(x) for x in _merge_splits(jnp.asarray(hi), jnp.asarray(lo), run, tile)]


# jitted, so that one shape compiles once for all the inputs that share it
_local_merge_pass = jax.jit(mp._local_merge_pass, static_argnames=(
    "levels", "chunk_rows", "width", "real_rows", "interpret"))
_merge_pass = jax.jit(mp._merge_pass, static_argnames=("t", "width", "real_rows", "interpret"))
_merge_splits = jax.jit(mp.merge_splits, static_argnums=(2, 3))


def _jax_local_merge(key, levels, chunk, width, tile):
    hi, lo = _jax_layout(key, width, tile)
    out = _local_merge_pass(hi, lo, levels=tuple(levels), chunk_rows=chunk // width,
                            width=width, real_rows=len(key) // width, interpret=True)
    return _real_rows(*out, len(key))


def _jax_merge_pass(key, run, tile, width):
    a0, b0, aend, bend = [jnp.asarray(x) for x in _jax_splits(key, run, tile)]
    hi, lo = _jax_layout(key, width, tile)
    out = _merge_pass(hi, lo, a0 // width, b0 // width, a0, b0, aend, bend, t=tile,
                      width=width, real_rows=len(key) // width, interpret=True)
    return _real_rows(*out, len(key))


# --------------------------------------------------------------------------
# (a) merge_splits and every plain pass against the JAX function
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,tile,width,base_run,chunk", CONFIGS)
def test_merge_splits_match_jax_at_every_level(n, tile, width, base_run, chunk):
    key = _keys(n + tile, n)
    total = len(_padded(key))
    for run in _merge_runs(chunk, total):
        state = _runs(key, run)
        got = ms.merge_splits_plain(torch.from_numpy(state), run, tile)
        want = _jax_splits(state, run, tile)
        for g, w, dispatched in zip(got, want, ms.merge_splits(torch.from_numpy(state), run, tile)):
            assert g.dtype == torch.int64 and g.shape == (total // tile,)
            assert np.array_equal(g.numpy(), w)
            assert torch.equal(dispatched, g)  # a CPU tensor goes to the plain form
        a0, b0, aend, bend = (g.numpy() for g in got)
        assert np.all((a0 <= aend) & (b0 <= bend) & (aend - run <= a0) & (aend <= b0))


@pytest.mark.parametrize("kind", ["all_equal", "a_above_b", "b_above_a", "sentinels_only"])
def test_merge_splits_match_jax_where_the_search_ends_at_an_edge(kind):
    n, run, tile = 1024, 128, 32
    up = np.arange(n, dtype=np.int64)
    pair_pos = up % (2 * run)
    key = {"all_equal": np.full(n, 77, np.int64),
           "a_above_b": np.where(pair_pos < run, pair_pos + 10_000, pair_pos),
           "b_above_a": up,
           "sentinels_only": np.full(n, SENTINEL, np.int64)}[kind]
    got = ms.merge_splits_plain(torch.from_numpy(key), run, tile)
    for g, w in zip(got, _jax_splits(key, run, tile)):
        assert np.array_equal(g.numpy(), w)
    if kind == "all_equal":  # ties: the largest j, so A's equal keys go first
        d = np.arange(0, n, tile) % (2 * run)
        assert np.array_equal(got[0].numpy() % (2 * run), np.minimum(d, run))


@pytest.mark.parametrize("n,tile,width,base_run,chunk",
                         [c for c in CONFIGS if c[3] != c[4]])
def test_local_merge_plain_matches_pallas(n, tile, width, base_run, chunk):
    state = _runs(_keys(n + 1, n), base_run)
    levels = _levels(base_run, chunk)
    got = ms.local_merge(torch.from_numpy(state), levels, chunk=chunk).numpy()
    assert np.array_equal(got, _jax_local_merge(state, levels, chunk, width, tile))
    assert np.array_equal(got, _runs(state, chunk))


@pytest.mark.parametrize("n,tile,width,base_run,chunk", CONFIGS)
def test_merge_pass_plain_matches_pallas(n, tile, width, base_run, chunk):
    key = _keys(n + 2, n)
    total = len(_padded(key))
    runs = _merge_runs(chunk, total)
    if n >= 65536:  # interpret mode is slow: the first and the last level
        runs = [runs[0], runs[-1]]
    for run in runs:
        state = _runs(key, run)
        t = torch.from_numpy(state)
        got = ms.merge_pass(t, ms.merge_splits(t, run, tile), run=run, tile=tile).numpy()
        assert np.array_equal(got, _jax_merge_pass(state, run, tile, width))
        assert np.array_equal(got, _runs(state, 2 * run))


def test_local_merge_plain_is_the_network_also_on_invalid_input():
    """Runs NOT ascending: the pass is the odd-even network, not a sort, and
    still equals the Pallas pass."""
    n, tile, width, base_run, chunk = 4096, 512, 128, 128, 1024
    key = _keys(3, n)
    levels = _levels(base_run, chunk)
    got = ms.local_merge(torch.from_numpy(key), levels, chunk=chunk).numpy()
    assert np.array_equal(got, _jax_local_merge(key, levels, chunk, width, tile))
    assert not np.array_equal(got, _runs(key, chunk))
    assert np.array_equal(np.sort(got), np.sort(key))


@pytest.mark.parametrize("kind", ["all_equal", "sorted", "reversed_run_pairs",
                                  "sentinels_only"])
def test_passes_on_degenerate_inputs_match_pallas(kind):
    n, tile, width, base_run, chunk = 2048, 128, 128, 128, 512
    base = np.sort(_keys(5, n))
    pairs = base.reshape(-1, 2, chunk)[:, ::-1].reshape(-1)  # every A wholly above its B
    key = {"all_equal": np.full(n, 12345, np.int64), "sorted": base,
           "reversed_run_pairs": pairs,
           "sentinels_only": np.full(n, SENTINEL, np.int64)}[kind]
    levels = _levels(base_run, chunk)
    t = torch.from_numpy(key)
    assert np.array_equal(ms.local_merge(t, levels, chunk=chunk).numpy(),
                          _jax_local_merge(key, levels, chunk, width, tile))
    state = _runs(key, chunk)
    t = torch.from_numpy(state)
    splits = ms.merge_splits(t, chunk, tile)
    got = ms.merge_pass(t, splits, run=chunk, tile=tile).numpy()
    assert np.array_equal(got, _jax_merge_pass(state, chunk, tile, width))
    _assert_segments_tile_the_runs(splits, chunk, tile)
    assert np.array_equal(ms.sort_keys_mergepath(
        torch.from_numpy(key), tile=tile, base_run=base_run, chunk=chunk).numpy(), np.sort(key))


def _assert_segments_tile_the_runs(splits, run, tile):
    """What the merge_pass kernel derives from a0, b0 alone: every tile's two
    segments lie inside their runs, sum to the tile, and follow one another
    so that each run is consumed once from its start to its end."""
    a0, b0, aend, bend = splits
    a1, b1 = ms.tile_segments(splits, run, tile)
    assert a1.dtype == b1.dtype == torch.int64 and a1.shape == b1.shape == a0.shape
    assert bool(((a1 - a0) + (b1 - b0) == tile).all())
    assert bool(((a0 <= a1) & (a1 <= aend) & (b0 <= b1) & (b1 <= bend)).all())
    per_pair = 2 * run // tile
    for x0, x1, end in ((a0, a1, aend), (b0, b1, bend)):
        x0, x1, end = (x.view(-1, per_pair) for x in (x0, x1, end))
        assert torch.equal(x1[:, :-1], x0[:, 1:])
        assert torch.equal(x1[:, -1], end[:, -1]) and torch.equal(x0[:, 0], end[:, 0] - run)


@pytest.mark.parametrize("kind", ["all_equal", "sorted", "reversed_run_pairs",
                                  "sentinels_only", "random"])
@pytest.mark.parametrize("run,tile", [(512, 128), (64, 64), (64, 2), (256, 16)])
def test_tile_segments_sum_to_the_tile_on_degenerate_inputs(kind, run, tile):
    """The inputs of test_passes_on_degenerate_inputs_match_pallas, and random
    keys with ties: the ends the kernel derives give ``la + lb == tile``."""
    n = 2048
    base = np.sort(_keys(5, n))
    pairs = base.reshape(-1, 2, run)[:, ::-1].reshape(-1)
    key = {"all_equal": np.full(n, 12345, np.int64), "sorted": base,
           "reversed_run_pairs": pairs, "sentinels_only": np.full(n, SENTINEL, np.int64),
           "random": _keys(6, n)}[kind]
    state = torch.from_numpy(_runs(key, run))
    _assert_segments_tile_the_runs(ms.merge_splits(state, run, tile), run, tile)


@pytest.mark.parametrize("base_run", [1, 2, 4, 16, 128, 512])
def test_sort_from_any_base_run_matches_torch_sort_and_jax(base_run):
    """base_run 1 (no library row sort: local_merge sorts the whole chunk) up
    to the chunk, on the same numpy-seeded keys as the JAX sort."""
    n, tile, width, chunk = 5000, 128, 128, 512
    key = _keys(n + base_run, n)
    t = torch.from_numpy(key.copy())
    got = ms.sort_keys_mergepath(t, tile=tile, base_run=base_run, chunk=chunk).numpy()
    assert np.array_equal(got, np.sort(key))
    assert np.array_equal(t.numpy(), key)
    hi, lo = convert.key_to_lanes(key)
    jhi, jlo = mp.sort_pairs_mergepath(jnp.asarray(hi), jnp.asarray(lo), tile=tile, width=width,
                                       base_run=max(base_run, width), chunk=chunk, interpret=True)
    assert np.array_equal(got, convert.lanes_to_key(np.asarray(jhi), np.asarray(jlo)))


def test_base_run_1_calls_no_library_row_sort(monkeypatch):
    local = _count_calls(monkeypatch, "local_merge_plain")
    key = torch.from_numpy(_keys(12, 1000))
    want = torch.sort(key).values
    sorts = []
    real_sort = torch.sort
    monkeypatch.setattr(torch, "sort", lambda *a, **k: sorts.append(a) or real_sort(*a, **k))
    assert torch.equal(ms.sort_keys_mergepath(key, tile=16, base_run=1, chunk=64), want)
    assert (len(local), len(sorts)) == (1, 0)
    assert torch.equal(ms.sort_keys_mergepath(key, tile=16, base_run=8, chunk=64), want)
    assert (len(local), len(sorts)) == (2, 1)


@pytest.mark.parametrize("levels", [[2, 8], [4, 16], [2, 4, 16], [8, 64], []])
def test_local_merge_refuses_levels_that_do_not_double(levels):
    """The kernel merges runs of levels[0] / 2 up to levels[-1] in rounds, so
    the levels are one unbroken run of powers of two; both forms refuse others."""
    with pytest.raises(ValueError):
        ms.local_merge(_K, levels, chunk=64)
    with pytest.raises(ValueError):
        ms.local_merge_plain(_K, levels, chunk=64)
    with pytest.raises(ValueError):
        ms.check_levels(levels, 64)
    ms.check_levels([4, 8, 16], 64)  # an unbroken run is taken


@pytest.mark.parametrize("tile", [2, 16, 64])
def test_merge_pass_plain_on_a_total_that_is_no_power_of_two(tile):
    run = 64
    state = np.sort(_keys(6, 6 * run).reshape(-1, run), axis=1).reshape(-1)  # three run pairs
    t = torch.from_numpy(state)
    got = ms.merge_pass(t, ms.merge_splits(t, run, tile), run=run, tile=tile).numpy()
    assert np.array_equal(got, np.sort(state.reshape(-1, 2 * run), axis=1).reshape(-1))


def test_merge_pass_writes_into_out_and_leaves_its_input():
    run, tile = 64, 16
    state = _runs(_keys(7, 512), run)
    t = torch.from_numpy(state.copy())
    out = torch.zeros_like(t)
    got = ms.merge_pass(t, ms.merge_splits(t, run, tile), run=run, tile=tile, out=out)
    assert got.data_ptr() == out.data_ptr()
    assert np.array_equal(out.numpy(), _runs(state, 2 * run))
    assert np.array_equal(t.numpy(), state)
    with pytest.raises(ValueError):
        ms.merge_pass(t, ms.merge_splits(t, run, tile), run=run, tile=tile, out=t)


def test_merge_pass_refuses_an_out_that_overlaps_its_keys():
    run, tile = 64, 16
    buf = torch.from_numpy(np.concatenate([_runs(_keys(8, 512), run)] * 2))
    key, splits = buf[:512], ms.merge_splits(buf[:512], run, tile)
    for out in (buf[tile:512 + tile], buf[511:1023], buf[:1024:2]):
        with pytest.raises(ValueError):
            ms.merge_pass(key, splits, run=run, tile=tile, out=out)
    got = ms.merge_pass(key, splits, run=run, tile=tile, out=buf[512:])
    assert np.array_equal(got.numpy(), _runs(key.numpy(), 2 * run))


# --------------------------------------------------------------------------
# (b) the composed sort, at the configurations of tests/test_mergepath.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,tile,width,base_run,chunk", CONFIGS)
def test_sort_keys_mergepath_matches_sort_pairs_mergepath(n, tile, width, base_run, chunk):
    key = _keys(n + tile, n)
    hi, lo = convert.key_to_lanes(key)
    jhi, jlo = mp.sort_pairs_mergepath(jnp.asarray(hi), jnp.asarray(lo), tile=tile, width=width,
                                       base_run=base_run, chunk=chunk, interpret=True)
    t = torch.from_numpy(key.copy())
    got = ms.sort_keys_mergepath(t, tile=tile, base_run=base_run, chunk=chunk).numpy()
    assert got.shape == (n,)
    assert np.array_equal(got, convert.lanes_to_key(np.asarray(jhi), np.asarray(jlo)))
    assert np.array_equal(got, np.sort(key))
    assert np.array_equal(t.numpy(), key)  # the caller's tensor is untouched


def _count_calls(monkeypatch, name):
    calls = []
    real = getattr(ms, name)

    def counting(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(ms, name, counting)
    return calls


def _jax_runs_kernels(n, **kw):
    hi = jnp.zeros((n,), jnp.uint32)
    text = str(jax.make_jaxpr(
        lambda a, b: mp.sort_pairs_mergepath(a, b, interpret=True, **kw))(hi, hi))
    return "pallas_call" in text


@pytest.mark.parametrize("n,network", [(1, False), (100, False), (255, False), (256, True),
                                       (257, True)])
def test_threshold_matches_jax(monkeypatch, n, network):
    """Below four chunks both packages sort with the library."""
    calls = _count_calls(monkeypatch, "merge_pass_plain")
    key = _keys(8, max(n, 16))[:n]
    got = ms.sort_keys_mergepath(torch.from_numpy(key), tile=16, base_run=8, chunk=64)
    assert np.array_equal(got.numpy(), np.sort(key))
    assert bool(calls) == network
    assert _jax_runs_kernels(n, tile=16, width=8, base_run=8, chunk=64) == network


def test_pass_counts_follow_from_the_sizes(monkeypatch):
    """n = 1000, chunk 64: pads to 1024; one local pass, log2(1024 / 64)
    merge passes, as many split searches.  base_run == chunk: no local pass.
    The default base_run, whatever it is, gives the same counts as any other
    below the chunk."""
    local = _count_calls(monkeypatch, "local_merge_plain")
    passes = _count_calls(monkeypatch, "merge_pass_plain")
    splits = _count_calls(monkeypatch, "merge_splits")
    key = torch.from_numpy(_keys(10, 1000))
    want = torch.sort(key).values
    assert torch.equal(ms.sort_keys_mergepath(key, tile=16, base_run=8, chunk=64), want)
    assert (len(local), len(passes), len(splits)) == (1, 4, 4)
    assert torch.equal(ms.sort_keys_mergepath(key, tile=64, base_run=64, chunk=64), want)
    assert (len(local), len(passes), len(splits)) == (1, 8, 8)
    assert torch.equal(ms.sort_keys_mergepath(key, tile=2, base_run=1, chunk=2), want)
    assert (len(local), len(passes)) == (2, 17)
    assert ms.DEFAULT_BASE_RUN < 64  # else the next call has no local pass
    assert torch.equal(ms.sort_keys_mergepath(key, tile=16, chunk=64), want)
    assert (len(local), len(passes), len(splits)) == (3, 21, 21)


def test_defaults_are_read_at_call_time(monkeypatch):
    calls = _count_calls(monkeypatch, "merge_pass_plain")
    key = torch.from_numpy(_keys(11, 700))
    assert torch.equal(ms.sort_keys_mergepath(key), torch.sort(key).values)
    assert not calls  # 700 keys are far below four default chunks
    monkeypatch.setattr(ms, "DEFAULT_MERGE_TILE", 16)
    monkeypatch.setattr(ms, "DEFAULT_BASE_RUN", 8)
    monkeypatch.setattr(ms, "DEFAULT_MERGE_CHUNK", 64)
    assert torch.equal(ms.sort_keys_mergepath(key), torch.sort(key).values)
    assert len(calls) == 4


def test_sentinel_lanes_sort_last_as_int64_max():
    hi = np.array([0xFFFFFFFF, 5, 0], np.uint32)
    lo = np.array([0xFFFFFFFF, 7, 1], np.uint32)
    key = convert.lanes_to_key(hi, lo)
    got = ms.sort_keys_mergepath(torch.from_numpy(np.tile(key, 100)), tile=4, base_run=2, chunk=8)
    assert got[-100:].tolist() == [SENTINEL] * 100


# --------------------------------------------------------------------------
# what the functions refuse
# --------------------------------------------------------------------------

_K = torch.zeros(256, dtype=torch.int64)
_S = (_K[:16], _K[:16], _K[:16], _K[:16])


@pytest.mark.parametrize("call,exc", [
    (lambda: ms.sort_keys_mergepath(_K, tile=32, base_run=4, chunk=16), ValueError),
    (lambda: ms.sort_keys_mergepath(_K, tile=12, base_run=4, chunk=16), ValueError),
    (lambda: ms.sort_keys_mergepath(_K, tile=8, base_run=4, chunk=24), ValueError),
    (lambda: ms.sort_keys_mergepath(_K, tile=8, base_run=3, chunk=16), ValueError),
    (lambda: ms.sort_keys_mergepath(_K, tile=8, base_run=32, chunk=16), ValueError),
    (lambda: ms.sort_keys_mergepath(_K, tile=1, base_run=1, chunk=4), ValueError),
    (lambda: ms.sort_keys_mergepath(_K.int(), tile=8, base_run=4, chunk=16), TypeError),
    (lambda: ms.sort_keys_mergepath(_K.view(16, 16), tile=8, base_run=4, chunk=16), TypeError),
    (lambda: ms.merge_splits(_K, 16, 32), ValueError),
    (lambda: ms.merge_splits(_K, 24, 8), ValueError),
    (lambda: ms.merge_splits(_K[:48], 16, 8), ValueError),
    (lambda: ms.merge_splits(_K.int(), 16, 8), TypeError),
    (lambda: ms.merge_pass(_K, _S, run=16, tile=32), ValueError),
    (lambda: ms.merge_pass(_K, _S, run=16, tile=1), ValueError),
    (lambda: ms.merge_pass(_K.view(16, 16), _S, run=16, tile=16), ValueError),
    (lambda: ms.merge_pass(_K.int(), _S, run=16, tile=16), TypeError),
    (lambda: ms.local_merge(_K, [8, 4], chunk=16), ValueError),
    (lambda: ms.local_merge(_K, [6], chunk=16), ValueError),
    (lambda: ms.local_merge(_K, [16, 32], chunk=16), ValueError),
    (lambda: ms.local_merge(_K, [4], chunk=12), ValueError),
    (lambda: ms.local_merge(_K[:40], [4], chunk=16), ValueError),
    (lambda: ms.local_merge(_K.int(), [4], chunk=16), TypeError),
])
def test_bad_arguments_are_refused(call, exc):
    with pytest.raises(exc):
        call()


# --------------------------------------------------------------------------
# (c) properties: any keys, any valid sizes
# --------------------------------------------------------------------------

_key_lists = st.lists(
    st.one_of(st.integers(0, (1 << 62) - 1), st.integers(0, 7), st.just(SENTINEL)),
    min_size=0, max_size=700)


@settings(max_examples=60, deadline=None, database=None)
@given(keys=_key_lists, log_chunk=st.integers(1, 6), data=st.data())
def test_sort_equals_torch_sort_for_any_keys_and_sizes(keys, log_chunk, data):
    log_tile = data.draw(st.integers(1, log_chunk))
    log_base = data.draw(st.integers(0, log_chunk))
    key = torch.tensor(keys, dtype=torch.int64)
    got = ms.sort_keys_mergepath(key, tile=1 << log_tile, base_run=1 << log_base,
                                 chunk=1 << log_chunk)
    assert got.shape == key.shape
    assert bool((got[1:] >= got[:-1]).all())                         # sorted
    assert torch.equal(got, torch.sort(key).values)                  # the same multiset


@settings(max_examples=40, deadline=None, database=None)
@given(seed=st.integers(0, 2**31), log_run=st.integers(1, 7), pairs=st.integers(1, 3),
       data=st.data())
def test_one_merge_level_merges_every_run_pair(seed, log_run, pairs, data):
    run = 1 << log_run
    tile = 1 << data.draw(st.integers(1, log_run))
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 6, size=(2 * pairs, run)).astype(np.int64)  # ties across every split
    key[rng.random(key.shape) < 0.1] = SENTINEL
    state = torch.from_numpy(np.sort(key, axis=1).reshape(-1))
    got = ms.merge_pass(state, ms.merge_splits(state, run, tile), run=run, tile=tile)
    assert torch.equal(got.view(pairs, 2 * run), torch.sort(state.view(pairs, 2 * run), dim=1).values)

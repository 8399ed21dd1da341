"""Port vs JAX package: ops/vgenome.py, the counter-hash virtual genome (CPU).

``genome_bases`` and ``read_batch`` are held against the JAX package's at
tolerance 0 on positions made from a numpy seed, starts past 2^31 and up to
2^32 - 1 included (tests/test_vgenome.py::test_positions_past_2_31).
``read_starts`` has no JAX counterpart (the JAX scale tool draws starts with
``jax.random``): it is held to its contract -- in range, a pure function of
(seed, batch index), different across batches and seeds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genome_assembly_tpu.ops import vgenome as jvg
from genome_assembly_tpu_torch.ops import vgenome as tvg


def _positions(seed, n):
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    pos[:6] = [0, 1, (1 << 31) - 1, 1 << 31, 2_999_999_990, (1 << 32) - 1]
    return pos


@pytest.mark.parametrize("seed", [0, 5, 7, 123456789, (1 << 40) + 3])
def test_genome_bases_match_jax(seed):
    pos = _positions(seed % 1000, 50_000)
    want = np.asarray(jvg.genome_bases(seed, jnp.asarray(pos)))
    got = tvg.genome_bases(seed, torch.from_numpy(pos.astype(np.int64)))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    # any integer dtype of the same values gives the same bases
    assert torch.equal(tvg.genome_bases(seed, torch.from_numpy(pos.astype(np.int64)).view(2, -1)),
                       got.view(2, -1))


@pytest.mark.parametrize("read_len", [1, 31, 100])
def test_read_batch_matches_jax_past_2_31(read_len):
    starts = np.array([0, 12345, (1 << 31) - 50, 1 << 31, 2_999_999_900,
                       (1 << 32) - read_len], dtype=np.uint32)
    for seed in (0, 3):
        want = np.asarray(jvg.read_batch(seed, jnp.asarray(starts), read_len))
        got = tvg.read_batch(seed, torch.from_numpy(starts.astype(np.int64)), read_len)
        assert got.shape == (len(starts), read_len) and np.array_equal(got.numpy(), want)


def test_overlapping_reads_share_bases_and_bases_are_uniform():
    reads = tvg.read_batch(3, torch.tensor([100, 150]), 100)
    assert torch.equal(reads[0, 50:], reads[1, :50])
    counts = np.bincount(tvg.genome_bases(7, torch.arange(1 << 16)).numpy(), minlength=4)
    assert counts.min() > 0.95 * (1 << 14)


def test_read_starts_are_a_pure_function_of_the_batch():
    span = 3_000_000_000 - 100  # past 2^31
    a = tvg.read_starts(0, 5, 4096, span, device="cpu")
    assert a.dtype == torch.int64 and a.shape == (4096,)
    assert int(a.min()) >= 0 and int(a.max()) < span and int(a.max()) > 1 << 31
    assert torch.equal(a, tvg.read_starts(0, 5, 4096, span, device="cpu"))
    assert (a != tvg.read_starts(0, 6, 4096, span, device="cpu")).float().mean() > 0.99
    assert (a != tvg.read_starts(1, 5, 4096, span, device="cpu")).float().mean() > 0.99
    # a batch's first reads do not depend on the batch size
    assert torch.equal(a[:100], tvg.read_starts(0, 5, 100, span, device="cpu"))
    small = tvg.read_starts(2, 0, 10_000, 200_000 - 100, device="cpu")
    assert small.unique().numel() > 9_000
    with pytest.raises(ValueError):
        tvg.read_starts(0, 0, 4, 0, device="cpu")

"""The lane gather (ops/lane_gather.py) against the JAX package's TPU kernel.

The kernel is ``gk`` of ``tools/bench_prims.py``, local to that tool's
``main()``; it is rebuilt here as the tool writes it (``take_along_axis``
along the rows of whole-array VMEM blocks) and run through ``pallas_call``
in interpret mode on the CPU.  Inputs are made with numpy from a seed;
tolerance 0 (bit-exact).  An int64 key is JAX's two uint32 lanes (the
port's ``convert``): both lanes gathered with the same indices.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from genome_assembly_tpu_torch.ops import lane_gather


def gk(x_ref, i_ref, o_ref):
    o_ref[:, :] = jnp.take_along_axis(x_ref[:, :], i_ref[:, :], axis=1)


def pallas_gather(x, idx):
    return pl.pallas_call(
        gk,
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(x, idx)


def _indices(rng, shape, pattern):
    rows, cols = shape
    if pattern == "random":
        return rng.integers(0, cols, size=shape)
    if pattern == "zero":
        return np.zeros(shape, dtype=np.int64)
    if pattern == "last":
        return np.full(shape, cols - 1, dtype=np.int64)
    return np.broadcast_to(np.arange(cols), shape).copy()  # identity


def _jax_gather(x_np, idx_np):
    """gk on the uint32 lanes of x (one lane for 32-bit values, hi and lo for
    64-bit), int32 indices; the result in x's dtype."""
    idx = jnp.asarray(idx_np.astype(np.int32))
    if x_np.dtype == np.int32:
        return np.asarray(pallas_gather(jnp.asarray(x_np.view(np.uint32)), idx)).view(np.int32)
    u = x_np.view(np.uint64)
    hi = np.asarray(pallas_gather(jnp.asarray((u >> np.uint64(32)).astype(np.uint32)), idx))
    lo = np.asarray(pallas_gather(jnp.asarray((u & np.uint64(0xFFFFFFFF)).astype(np.uint32)), idx))
    return ((hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)).view(np.int64)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("shape", [(256, 128), (8, 1024)])
@pytest.mark.parametrize("pattern", ["random", "zero", "last", "identity"])
def test_plain_equals_the_tpu_kernel(shape, dtype, pattern):
    rng = np.random.default_rng(7 + shape[1])
    info = np.iinfo(dtype)
    x_np = rng.integers(info.min, info.max, size=shape, dtype=dtype, endpoint=True)
    idx_np = _indices(rng, shape, pattern).astype(dtype)
    want = _jax_gather(x_np, idx_np)
    got = lane_gather.lane_gather_plain(torch.from_numpy(x_np), torch.from_numpy(idx_np))
    assert got.dtype == torch.from_numpy(x_np).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    # the dispatcher sends a CPU tensor to the plain version
    np.testing.assert_array_equal(
        lane_gather.lane_gather(torch.from_numpy(x_np), torch.from_numpy(idx_np)).numpy(), want)


def test_dispatcher_takes_the_plain_version_for_cpu_tensors(monkeypatch):
    calls = []
    real = lane_gather.lane_gather_plain
    monkeypatch.setattr(lane_gather, "lane_gather_plain",
                        lambda x, idx: (calls.append(x.shape), real(x, idx))[1])
    x = torch.arange(20, dtype=torch.int64).view(4, 5)
    idx = torch.tensor([[4, 0, 1, 1, 2]] * 4)
    out = lane_gather.lane_gather(x, idx)
    assert calls == [(4, 5)]
    assert torch.equal(out, torch.gather(x, 1, idx))


@pytest.mark.parametrize("bad", [-1, 5, 1 << 40])
def test_dispatcher_refuses_indices_outside_the_row(bad):
    x = torch.zeros((3, 5), dtype=torch.int64)
    idx = torch.zeros((3, 5), dtype=torch.int64)
    idx[2, 3] = bad
    with pytest.raises(ValueError, match=r"\[0, 5\)"):
        lane_gather.lane_gather(x, idx)


@pytest.mark.parametrize("x, idx", [
    (torch.zeros((3, 5), dtype=torch.int32), torch.zeros((3, 5), dtype=torch.int64)),
    (torch.zeros((3, 5), dtype=torch.int64), torch.zeros((3, 5), dtype=torch.int32)),
    (torch.zeros((3, 5), dtype=torch.float32), torch.zeros((3, 5), dtype=torch.int32)),
    (torch.zeros((3, 5), dtype=torch.int32), torch.zeros((3, 4), dtype=torch.int32)),
    (torch.zeros(15, dtype=torch.int32), torch.zeros(15, dtype=torch.int32)),
])
def test_dispatcher_refuses_what_the_kernel_does_not_take(x, idx):
    with pytest.raises((TypeError, ValueError)):
        lane_gather.lane_gather(x, idx)


def test_empty_rows_gather_nothing():
    x = torch.zeros((0, 4), dtype=torch.int32)
    assert lane_gather.lane_gather(x, torch.zeros((0, 4), dtype=torch.int32)).shape == (0, 4)


def test_bench_prims_runs_every_probe_on_the_cpu():
    from genome_assembly_tpu_torch.tools import bench_prims

    lines = bench_prims.main(["--cpu", "--reps", "1"], emit=lambda e: None)
    phases = [line["phase"] for line in lines]
    assert phases == ["env", "scatter_add_1.59M", "scatter_min_1.59M", "gather_1.59M",
                      "rowsort_192x8192", "rowsort_1536x1024", "sort_12.7M",
                      "lane_gather_c128", "lane_gather_c1024"]
    assert all(line["per_iter_ms"] > 0 and line["elems_per_s"] > 0 for line in lines[1:])
    assert all(line["ok"] for line in lines if line["phase"].startswith("lane_gather"))


def test_bench_prims_fails_loudly_when_the_lane_gather_differs(monkeypatch):
    from genome_assembly_tpu_torch.tools import bench_prims

    real = lane_gather.lane_gather
    monkeypatch.setattr(lane_gather, "lane_gather", lambda x, idx: real(x, idx) ^ 1)
    with pytest.raises(AssertionError, match="lane_gather at \\[256, 128\\]"):
        bench_prims.main(["--cpu", "--reps", "1"], emit=lambda e: None)

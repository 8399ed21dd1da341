"""Port vs JAX package: resumable count shards (``sharded_count_batches(
checkpoint_dir=)`` and ``utils/checkpoint.save_count_shards`` /
``load_count_shards``).

Batches of numpy-seeded reads (``test_torch_shard_count``'s) are counted
over CPU meshes: a run stopped after 2 of 4 batches, then resumed on the
same or another shard count, equals the uninterrupted run (kept table), and
equals the JAX package's run stopped and resumed alike row for row
(``convert.sharded_count_to_lanes``, tolerance 0).  Each package resumes
the other's directory.  The files carry JAX's fields and types.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_assembly_tpu.io import datagen
from genome_assembly_tpu.io import reads as jreads
from genome_assembly_tpu.parallel import mesh as jmesh_lib
from genome_assembly_tpu.parallel import shard_count as jsc
from genome_assembly_tpu_torch.common import MMER_SENTINEL, SENTINEL
from genome_assembly_tpu_torch.parallel import mesh as tmesh_lib
from genome_assembly_tpu_torch.parallel import shard_count as tsc
from genome_assembly_tpu_torch.utils import checkpoint as tckpt

from test_torch_shard_count import assert_same_count

K, M = 11, 5


@functools.lru_cache(maxsize=None)
def _batches(rows=24, seed=9):
    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=900, read_len=48, coverage=6, seed=seed, with_reverse=True)
    batches = [jreads.pad_batch(b, rows) for b in jreads.batch_reads(reads, 64, rows)]
    assert len(batches) >= 4
    return tuple(batches[:4])


@functools.lru_cache(maxsize=None)
def _meshes(n):
    return jmesh_lib.make_mesh(n), tmesh_lib.make_mesh(n, devices=["cpu"])


def _kw(route_by):
    return dict(k=K, m=M, parity=False, cutoff=1, route_by=route_by)


def _table(sc, mesh=None):
    if mesh is None:
        return jsc.sharded_to_host_dict(sc, K, M)
    return tsc.sharded_to_host_dict(sc, K, M, mesh)


@pytest.mark.parametrize("route_by", ["mmer", "key"])
@pytest.mark.parametrize("n_from,n_to", [(8, 8), (8, 4), (4, 8)])
def test_stopped_and_resumed_equals_the_uninterrupted_run_and_jax(tmp_path, n_from, n_to,
                                                                   route_by):
    batches = list(_batches())
    kw = _kw(route_by)
    (jfrom, tfrom), (jto, tto) = _meshes(n_from), _meshes(n_to)
    whole = tsc.sharded_count_batches(batches, mesh=tto, **kw)
    tsc.sharded_count_batches(batches[:2], mesh=tfrom, checkpoint_dir=tmp_path / "t", **kw)
    saved = json.loads((tmp_path / "t" / "manifest.json").read_text())
    assert (saved["batches_done"], saved["n_shards"]) == (2, n_from)
    got = tsc.sharded_count_batches(batches, mesh=tto, checkpoint_dir=tmp_path / "t", **kw)
    assert tto.total(got.overflow) == 0
    assert _table(got, tto) == _table(whole, tto)
    assert json.loads((tmp_path / "t" / "manifest.json").read_text())["batches_done"] == 4
    jsc.sharded_count_batches(batches[:2], mesh=jfrom, checkpoint_dir=str(tmp_path / "j"), **kw)
    want = jsc.sharded_count_batches(batches, mesh=jto, checkpoint_dir=str(tmp_path / "j"),
                                     **kw)
    assert_same_count(want, got)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_resumes_the_others_directory(tmp_path, writer):
    """A directory written after 2 batches by one package, resumed over all
    4 by the other, equals the writer's own full run."""
    batches = list(_batches())
    kw = _kw("mmer")
    jm, tm = _meshes(4)
    jfull = jsc.sharded_count_batches(batches, mesh=jm, **kw)
    if writer == "jax":
        jsc.sharded_count_batches(batches[:2], mesh=jm, checkpoint_dir=str(tmp_path), **kw)
        got = tsc.sharded_count_batches(batches, mesh=tm, checkpoint_dir=tmp_path, **kw)
        assert _table(got, tm) == _table(jfull)
        assert tm.total(got.overflow) == 0
    else:
        tsc.sharded_count_batches(batches[:2], mesh=tm, checkpoint_dir=tmp_path, **kw)
        got = jsc.sharded_count_batches(batches, mesh=jm, checkpoint_dir=str(tmp_path), **kw)
        assert _table(got) == _table(jfull)
        assert int(np.sum(np.asarray(got.overflow))) == 0
    assert json.loads((tmp_path / "manifest.json").read_text())["batches_done"] == 4


def test_files_carry_jax_fields_and_types(tmp_path):
    batches = list(_batches())
    kw = _kw("key")
    jm, tm = _meshes(4)
    tsc.sharded_count_batches(batches[:2], mesh=tm, checkpoint_dir=tmp_path / "t", **kw)
    jsc.sharded_count_batches(batches[:2], mesh=jm, checkpoint_dir=str(tmp_path / "j"), **kw)
    assert (json.loads((tmp_path / "t" / "manifest.json").read_text())
            == json.loads((tmp_path / "j" / "manifest.json").read_text()))
    for g in range(4):
        t = np.load(tmp_path / "t" / f"shard_{g}.npz")
        j = np.load(tmp_path / "j" / f"shard_{g}.npz")
        assert sorted(t.files) == sorted(j.files)
        for name in j.files:
            assert t[name].dtype == j[name].dtype, name
        # the same records (a shard's order is that of its parts)
        order_t = np.argsort(t["stream"], kind="stable")
        order_j = np.argsort(j["stream"], kind="stable")
        for name in ("mmer", "khi", "klo", "rid", "stream"):
            np.testing.assert_array_equal(t[name][order_t], j[name][order_j], err_msg=name)
        assert int(t["ovf"]) == int(j["ovf"]) == 0


def test_save_and_load_round_trip_and_wide_values(tmp_path):
    """Parts saved and loaded: the valid rows in order, FILLS to the longest
    shard, the overflow total on shard 0; read ids and streams past
    2^32 - 1 are written as int64, never wrapped."""
    tm = tmesh_lib.make_mesh(2, devices=["cpu"])
    big = (1 << 33) + 5
    parts = [
        [[torch.tensor([7, MMER_SENTINEL, 3], dtype=torch.int32),
          torch.tensor([70, SENTINEL, 30]), torch.tensor([1, SENTINEL, big]),
          torch.tensor([10, SENTINEL, 12]), torch.tensor(2)],
         [torch.tensor([9], dtype=torch.int32), torch.tensor([90]), torch.tensor([4]),
          torch.tensor([big]), torch.tensor(1)]],
        [[torch.tensor([5], dtype=torch.int32), torch.tensor([50]), torch.tensor([6]),
          torch.tensor([11]), torch.tensor(0)]],
    ]
    meta = dict(k=11, m=5, parity=False, batch_rows=8, max_len=16, route_by="mmer")
    tckpt.save_count_shards(tmp_path, parts, 3, meta, mesh=tm)
    s0 = np.load(tmp_path / "shard_0.npz")
    assert s0["rid"].dtype == np.int64 and s0["stream"].dtype == np.int64
    assert s0["mmer"].dtype == np.uint32 and int(s0["ovf"]) == 3
    assert np.load(tmp_path / "shard_1.npz")["rid"].dtype == np.uint32
    loaded, done = tckpt.load_count_shards(tmp_path, mesh=tm, expect=meta)
    assert done == 3
    assert loaded[0][0].tolist() == [7, 3, 9] and loaded[0][2].tolist() == [1, big, 4]
    assert loaded[0][3].tolist() == [10, 12, big] and loaded[0][1].tolist() == [70, 30, 90]
    assert loaded[1][0].tolist() == [5, MMER_SENTINEL, MMER_SENTINEL]
    assert loaded[1][1].tolist() == [50, SENTINEL, SENTINEL]
    assert [int(p[4]) for p in loaded] == [3, 0]
    assert tckpt.load_count_shards(tmp_path / "none", mesh=tm, expect=meta) is None


def test_a_manifest_of_another_run_raises(tmp_path):
    batches = list(_batches())
    _, tm = _meshes(4)
    tsc.sharded_count_batches(batches[:2], mesh=tm, checkpoint_dir=tmp_path, **_kw("mmer"))
    with pytest.raises(ValueError, match="different run"):
        tsc.sharded_count_batches(batches, mesh=tm, checkpoint_dir=tmp_path,
                                  **dict(_kw("mmer"), k=13))
    with pytest.raises(ValueError, match="route_by"):
        tsc.sharded_count_batches(batches, mesh=tm, checkpoint_dir=tmp_path, **_kw("key"))
    # a manifest without route_by (an older JAX file) means minimizer routing
    path = tmp_path / "manifest.json"
    manifest = json.loads(path.read_text())
    del manifest["route_by"]
    path.write_text(json.dumps(manifest))
    got = tsc.sharded_count_batches(batches, mesh=tm, checkpoint_dir=tmp_path, **_kw("mmer"))
    whole = tsc.sharded_count_batches(batches, mesh=tm, **_kw("mmer"))
    assert _table(got, tm) == _table(whole, tm)
    with pytest.raises(ValueError, match="route_by"):
        tsc.sharded_count_batches(batches, mesh=tm, checkpoint_dir=tmp_path, **_kw("key"))


def test_saves_follow_checkpoint_every_and_the_end(tmp_path):
    batches = list(_batches())
    _, tm = _meshes(4)
    seen = []
    tsc.sharded_count_batches(batches[:3], mesh=tm, checkpoint_dir=tmp_path,
                              checkpoint_every=2, on_checkpoint=seen.append, **_kw("mmer"))
    assert seen == [2, 3]
    seen.clear()
    tsc.sharded_count_batches(batches, mesh=tm, checkpoint_dir=tmp_path,
                              on_checkpoint=seen.append, **_kw("mmer"))
    assert seen == [4]

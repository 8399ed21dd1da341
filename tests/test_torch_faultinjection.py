"""Kill and resume a distributed count (gloo, CPU processes).

``genome_assembly_tpu_torch/tools/run_multihost_ckpt.py`` runs a
checkpointed multi-batch count over N worker processes (subprocesses, so
this run's JAX import stays out of them).  A rank SIGKILLs itself right
after a batch's checkpoint commits (``--die-after-batch``, ``--die-rank``);
the launcher stops the rest.  A relaunch on the same directory resumes
there, and ``tools/run_elastic.supervise`` relaunches a world one process
smaller.  Each finished run's table hash equals the uninterrupted count's,
over a one-process mesh and in the JAX package (the hash of
tests/test_faultinjection.py: sorted kept (mmer, kmer, count)).
"""

import hashlib
import json
import os

import jax.numpy  # noqa: F401  (the JAX side runs on the conftest's CPU devices)
import pytest

from genome_assembly_tpu.io import datagen as jdatagen
from genome_assembly_tpu.io import reads as jreads
from genome_assembly_tpu.parallel import mesh as jmesh_lib
from genome_assembly_tpu.parallel import shard_count as jsc
from genome_assembly_tpu_torch.parallel import mesh as tmesh_lib
from genome_assembly_tpu_torch.parallel import shard_count as tsc
from genome_assembly_tpu_torch.tools import run_elastic, run_multihost, run_multihost_ckpt

ROWS = 24
D = run_multihost_ckpt.DATASET
TIMEOUT = 120


@pytest.fixture(autouse=True)
def cpu_only(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    for name in list(os.environ):
        if name.startswith(("XLA_", "JAX_")):
            monkeypatch.delenv(name)


def _uninterrupted(rows):
    """(entries, digest) of the uninterrupted count: the port over a
    one-process mesh of 2 CPU shards, held to the JAX package's."""
    batches = run_multihost_ckpt.batches_of(**dict(D, rows=rows))
    mesh = tmesh_lib.make_mesh(2, devices=["cpu"])
    sc = tsc.sharded_count_batches(batches, k=D["k"], m=D["m"], parity=False,
                                   cutoff=D["cutoff"], mesh=mesh)
    got = run_multihost.table_digest(sc, mesh, D["k"], D["m"])
    _, reads, _ = jdatagen.generate_coverage_reads(
        genome_len=D["genome_len"], read_len=D["read_len"], coverage=D["coverage"],
        seed=D["seed"], with_reverse=True)
    jb = [jreads.pad_batch(b, rows) for b in jreads.batch_reads(reads, D["max_read_len"], rows)]
    table = jsc.sharded_to_host_dict(jsc.sharded_count_batches(
        jb, k=D["k"], m=D["m"], parity=False, cutoff=D["cutoff"],
        mesh=jmesh_lib.make_mesh(8)), D["k"], D["m"])
    canon = sorted((mm, kk, len(v)) for (mm, kk), v in table.items())
    assert got == (len(table), hashlib.sha256(json.dumps(canon).encode()).hexdigest())
    return got


def _world(procs, ckpt, **flags):
    args = run_multihost_ckpt.parse_args(
        ["--procs", str(procs), "--ckpt-dir", str(ckpt), "--device", "cpu",
         "--backend", "gloo", "--rows", str(ROWS), "--timeout", str(TIMEOUT)])
    for name, value in flags.items():
        setattr(args, name, value)
    return run_multihost_ckpt.run_world(args)


def test_two_process_kill_and_resume(tmp_path):
    """Rank 1 dies after batch 2's checkpoint; both workers stop; a fresh
    2-process launch resumes at batch 2 and ends with the uninterrupted
    table."""
    rcs, tails, timed_out, summary = _world(2, tmp_path, die_after_batch=2, die_rank=1)
    assert rcs[1] == -9 and rcs[0] != 0 and not timed_out, tails
    assert summary is None
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert (manifest["batches_done"], manifest["n_shards"]) == (2, 2)
    rcs, tails, _, got = _world(2, tmp_path)
    assert rcs == [0, 0], tails
    assert got["resumed_from"] == 2 and got["n_batches"] == 5 and got["overflow"] == 0
    assert (got["entries"], got["digest"]) == _uninterrupted(ROWS)
    assert got["checkpoint_bytes"] > 0 and got["save_seconds"] > 0


def test_elastic_three_to_two(tmp_path):
    """A 3-process world loses rank 2 after batch 1; the supervisor
    relaunches 2 processes on the same directory, which resume at batch 1
    with the 3-shard records routed onto 2 shards."""
    got = run_elastic.supervise(3, tmp_path / "e.json", tmp_path / "ck", 1, 2, device="cpu",
                                backend="gloo", timeout=TIMEOUT, rows=ROWS)
    assert got == json.loads((tmp_path / "e.json").read_text())
    assert got["attempts"] == [3, 2]
    s = got["summary"]
    assert (s["resumed_from"], s["devices"], s["overflow"]) == (1, 2, 0)
    assert (s["entries"], s["digest"]) == _uninterrupted(ROWS)


@pytest.mark.slow
def test_four_process_nonzero_rank_kill_and_resume(tmp_path):
    """Only rank 2 of 4 dies, after batch 1; the others fail on the broken
    collective; a fresh 4-process launch resumes at batch 1."""
    rcs, tails, _, _ = _world(4, tmp_path, die_after_batch=1, die_rank=2)
    assert rcs[2] == -9 and all(rc != 0 for rc in rcs), tails
    assert json.loads((tmp_path / "manifest.json").read_text())["n_shards"] == 4
    rcs, tails, _, got = _world(4, tmp_path)
    assert rcs == [0] * 4, tails
    assert got["resumed_from"] == 1 and got["overflow"] == 0
    assert (got["entries"], got["digest"]) == _uninterrupted(ROWS)


@pytest.mark.slow
def test_elastic_shrink_world_resume(tmp_path):
    """A 4-process world loses rank 2 after batch 1; a 3-process world
    resumes on the same directory (4 shards' records on 3) and ends with
    an uninterrupted 4-process run's table."""
    got = run_elastic.supervise(4, tmp_path / "e.json", tmp_path / "ck", 1, 2, device="cpu",
                                backend="gloo", timeout=TIMEOUT, rows=48)
    assert got["attempts"] == [4, 3]
    assert (got["summary"]["resumed_from"], got["summary"]["devices"]) == (1, 3)
    base = run_elastic.supervise(4, tmp_path / "b.json", tmp_path / "ck_base", device="cpu",
                                 backend="gloo", timeout=TIMEOUT, rows=48)
    assert base["attempts"] == [4]
    for key in ("digest", "entries", "overflow"):
        assert base["summary"][key] == got["summary"][key]
    assert (got["summary"]["entries"], got["summary"]["digest"]) == _uninterrupted(48)

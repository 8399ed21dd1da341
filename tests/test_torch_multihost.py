"""Two and four processes, one shard each, over torch.distributed (gloo, CPU).

``genome_assembly_tpu_torch/tools/run_multihost.py`` launches two worker
processes (a subprocess each, so this test run's JAX import stays out of
them) joined by ``init_multi_host`` on a free port.  Each runs the flat
count and ``FastAssembler.unitigs(mesh=)`` over the global mesh; rank 0's
summary must equal the same summary over a one-process mesh of two CPU
shards, and its count hash the JAX package's over its 8-device mesh (the
hash of tests/test_multihost.py: sorted kept (mmer, kmer, count)).  The
workers also count with the two-level router over the ranks as a
``(procs // 2, 2)`` mesh (sub-groups of ``torch.distributed``): its hash
must be the flat one's.
"""

import hashlib
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import pytest

from genome_assembly_tpu.io import datagen as jdatagen
from genome_assembly_tpu.io import reads as jreads
from genome_assembly_tpu.parallel import mesh as jmesh_lib
from genome_assembly_tpu.parallel import shard_count as jsc
from genome_assembly_tpu_torch.parallel import mesh as tmesh_lib
from genome_assembly_tpu_torch.tools import run_multihost

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jax_digest(d):
    _, reads, _ = jdatagen.generate_coverage_reads(
        genome_len=d["genome_len"], read_len=d["read_len"], coverage=d["coverage"],
        seed=d["seed"], with_reverse=True)
    (b,) = jreads.batch_reads(reads, d["max_read_len"])
    b = jreads.pad_batch(b, 8 * -(-len(reads) // 8))
    sc = jsc.sharded_count(jnp.asarray(b.codes), jnp.asarray(b.lengths),
                           jnp.asarray(b.read_ids), k=d["k"], m=d["m"], parity=False,
                           cutoff=d["cutoff"], mesh=jmesh_lib.make_mesh(8))
    table = jsc.sharded_to_host_dict(sc, d["k"], d["m"])
    canon = sorted((mm, kk, len(v)) for (mm, kk), v in table.items())
    return len(table), hashlib.sha256(json.dumps(canon).encode()).hexdigest()


def _launch(tmp_path, procs):
    out = tmp_path / "summary.json"
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run(
        [sys.executable, "-m", "genome_assembly_tpu_torch.tools.run_multihost",
         "--procs", str(procs), "--backend", "gloo", "--device", "cpu", "--out", str(out),
         "--timeout", "280"],
        cwd=str(REPO_ROOT), env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    got = json.loads(out.read_text())
    assert json.loads(r.stdout.strip().splitlines()[-1]) == got
    return got


def test_two_gloo_processes_equal_the_one_process_mesh(tmp_path):
    got = _launch(tmp_path, 2)
    assert (got["processes"], got["shards"], got["backend"], got["device"]) == (2, 2, "gloo", "cpu")
    assert got["overflow"] == 0 and got["n_unitigs"] > 0
    want = run_multihost.summarize(tmesh_lib.make_mesh(2, devices=["cpu"]),
                                   **run_multihost.DATASET)
    assert got["ragged_digest"] == got["digest"] == got["two_level_digest"]
    assert got["two_level3_digest"] is None
    for key in ("entries", "digest", "ragged_digest", "n_unitigs", "unitig_digest",
                "entries_post_prune", "overflow"):
        assert got[key] == want[key], key
    assert (got["entries"], got["digest"]) == _jax_digest(run_multihost.DATASET)


def test_four_gloo_processes_count_two_level_over_a_2x2_mesh(tmp_path):
    """Four workers: the two-level count over the ranks as a (2, 2) mesh,
    both axes across processes, hashes as the flat count, which equals the
    one-process mesh of 4 shards and the JAX package's hash."""
    got = _launch(tmp_path, 4)
    assert (got["processes"], got["shards"], got["overflow"]) == (4, 4, 0)
    assert got["two_level_digest"] == got["digest"] == got["ragged_digest"]
    assert got["two_level3_digest"] is None
    mesh = tmesh_lib.make_mesh(4, devices=["cpu"])
    want = run_multihost.summarize(
        mesh, **run_multihost.DATASET,
        two_level=tmesh_lib.make_mesh(devices=["cpu"], shape=(2, 2)))
    for key in ("entries", "digest", "two_level_digest", "n_unitigs", "unitig_digest"):
        assert got[key] == want[key], key
    assert (got["entries"], got["digest"]) == _jax_digest(run_multihost.DATASET)


def test_launcher_stops_the_workers_when_one_fails(tmp_path):
    """A worker that cannot run (here: k even, refused by the assembler)
    fails the launch with its log on stderr; no worker is left running."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", "genome_assembly_tpu_torch.tools.run_multihost",
         "--procs", "2", "--device", "cpu", "--k", "12", "--timeout", "120"],
        cwd=str(REPO_ROOT), env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "odd k" in r.stderr and "--- worker 0" in r.stderr


@pytest.mark.slow
def test_eight_gloo_processes_count_two_level_over_2x2_and_2x2x2(tmp_path):
    """Eight workers: the two-level count over (4, 2) and over (2, 2, 2),
    every axis across processes, hashes as the flat count."""
    got = _launch(tmp_path, 8)
    assert (got["processes"], got["shards"], got["overflow"]) == (8, 8, 0)
    assert got["two_level_digest"] == got["two_level3_digest"] == got["digest"]
    assert (got["entries"], got["digest"]) == _jax_digest(run_multihost.DATASET)

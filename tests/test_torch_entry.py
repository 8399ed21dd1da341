"""Port vs JAX package: the top-level entry points (``entry.py`` against the
repo's ``__graft_entry__.py``), on the CPU.

The port's ``entry()`` step equals the JAX package's on the same batch,
n_kept, head and rank, on the entry's own example arguments (random reads:
every k-mer is seen once, so nothing is kept and every state is a pad) and
on a batch of overlapping reads where most k-mers are kept.
``dryrun_multichip`` runs over a mesh of CPU shards.  Integers: tolerance 0.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from genome_assembly_tpu_torch import entry as tentry
from genome_assembly_tpu_torch.io import datagen
from genome_assembly_tpu_torch.io import reads as reads_io


def _coverage_batch():
    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=2000, read_len=128, coverage=16, seed=1, with_reverse=True)
    (batch,) = reads_io.batch_reads(reads, 128)
    return batch.codes, batch.lengths, batch.read_ids


@pytest.fixture(scope="module")
def steps():
    return jentry.entry(), tentry.entry("cpu")


@pytest.mark.parametrize("batch", ["example", "coverage"])
def test_entry_step_equals_jax(steps, batch):
    import jax.numpy as jnp

    (jstep, jargs), (tstep, targs) = steps
    if batch == "example":
        codes, lengths, _ = (np.array(a) for a in jargs)
        assert np.array_equal(targs[0].numpy(), codes)
        assert np.array_equal(targs[1].numpy(), lengths)
        assert targs[0].shape == (256, 128) and targs[0].device.type == "cpu"
        args = jargs
    else:
        codes, lengths, read_ids = _coverage_batch()
        args = (jnp.asarray(codes), jnp.asarray(lengths), jnp.asarray(read_ids))
    want = [np.asarray(x) for x in jstep(*args)]
    got = [x.numpy() for x in tstep(torch.from_numpy(codes), torch.from_numpy(lengths))]
    assert int(got[0]) == int(want[0])
    assert (int(got[0]) == 0) == (batch == "example")
    for w, g in zip(want[1:], got[1:]):
        assert g.shape == w.shape and np.array_equal(g, w)


def test_entry_runs_on_the_card_unless_asked():
    with pytest.raises(RuntimeError):
        tentry.entry()


def test_dryrun_multichip_on_cpu_shards(capsys):
    tentry.dryrun_multichip(4)
    assert "dryrun_multichip ok: 4 CPU shards" in capsys.readouterr().out


def test_dryrun_multichip_on_eight_cpu_shards(capsys):
    """The 8-shard dry run adds what the JAX package's adds: the two-level
    count over (2, 4) and (2, 2, 2) == the flat one, the halo exchange, and
    a checkpointed count resumed on half the shards."""
    tentry.dryrun_multichip(8)
    out = capsys.readouterr().out
    assert "dryrun_multichip ok: 8 CPU shards" in out
    assert "two-level over [(2, 4), (2, 2, 2)] == flat" in out
    assert "236 haloed windows" in out and "resumed on 4 shards" in out


@pytest.mark.parametrize("routing", ["padded", "ragged", "two_level"])
def test_bench_scaling_prints_the_jax_fields(capsys, routing):
    """``bench-scaling --cpu``: one JSON line a shard count, 1, 2, 4, with
    the JAX package's fields (``cli.cmd_bench_scaling`` there)."""
    import json

    from genome_assembly_tpu_torch import cli

    assert cli.main(["bench-scaling", "--devices", "4", "--routing", routing, "--cpu",
                     "--batch-reads", "256"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["shards"] for r in rows] == [1, 2, 4]
    assert all(set(r) == {"shards", "wall_s", "windows_per_s", "scaling_eff"} for r in rows)
    assert rows[0]["scaling_eff"] == 1.0
    assert all(r["wall_s"] > 0 and r["windows_per_s"] == 256 * (128 - 21 + 1) / r["wall_s"]
               for r in rows)


def test_bench_scaling_runs_on_the_card_unless_asked():
    from genome_assembly_tpu_torch import cli

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["bench-scaling", "--devices", "2"])

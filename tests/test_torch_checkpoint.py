"""Port vs JAX package: counted-table checkpoints (utils/checkpoint.py) and
the CLI's ``count --checkpoint`` (CPU).

A table round-trips through the port's save and load; a file written by
the port loads with the JAX package's ``load_counted_table`` and the
reverse, config included (``hybrid_sort`` <-> ``pallas_sort``); both CLIs'
``count --checkpoint --cpu`` give equal tables in both modes.  The invalid
tails of the two packages' tables differ by design (the port writes
sentinels there), so tables are compared on the valid prefix, the count of
invalid rows and the keep mask, as ``test_torch_parity_count.py`` does.
Integers: tolerance 0.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from genome_assembly_tpu import cli as jcli
from genome_assembly_tpu.config import PipelineConfig as JConfig
from genome_assembly_tpu.utils import checkpoint as jckpt
from genome_assembly_tpu_torch import cli as tcli
from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.config import PipelineConfig as TConfig
from genome_assembly_tpu_torch.io import datagen
from genome_assembly_tpu_torch.models.pipeline import CountPipeline
from genome_assembly_tpu_torch.utils import checkpoint as tckpt

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
FIELDS = ("mmer", "kmer_hi", "kmer_lo", "read_id", "stream_idx", "valid", "group_start",
          "count", "keep")


def _reads():
    return (GOLDEN / "input.txt").read_text().split()


def _same_tables(want, got):
    """Two tables as JAX lanes (tuples in FIELDS order): equal on the valid
    prefix, in the number of rows and in ``keep``."""
    want = [np.asarray(x) for x in want]
    got = [np.asarray(x) for x in got]
    n = int(want[5].sum())
    assert int(got[5].sum()) == n and want[5][:n].all() and got[5][:n].all()
    assert got[0].shape == want[0].shape
    for name, a, b in zip(FIELDS, got, want):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a[:n], b[:n], err_msg=name)
    np.testing.assert_array_equal(got[8], want[8], err_msg="keep")


@pytest.mark.parametrize("hybrid_sort", [False, True])
def test_round_trip(tmp_path, hybrid_sort):
    cfg = TConfig(k=6, m=3, max_read_len=32, batch_reads=8, hybrid_sort=hybrid_sort)
    table, _ = CountPipeline(cfg, device="cpu").count_reads(_reads())
    tckpt.save_counted_table(tmp_path / "t", table, cfg, phase="post-count")
    assert (tmp_path / "t.npz").exists() and (tmp_path / "t.meta.json").exists()
    back, cfg_back, phase = tckpt.load_counted_table(tmp_path / "t.npz")
    assert cfg_back == cfg and phase == "post-count"
    for name in table._fields:
        a, b = getattr(back, name), getattr(table, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    meta = json.loads((tmp_path / "t.meta.json").read_text())
    assert list(meta["config"]) == [f.name for f in dataclasses.fields(JConfig)]
    assert meta["config"]["pallas_sort"] is hybrid_sort and meta["config"]["pallas_scan"] is False


def test_files_cross_between_packages(tmp_path):
    """A port file loads in the JAX package, a JAX file in the port: the
    same lanes and config either way."""
    tcfg = TConfig(k=6, m=3, max_read_len=32, batch_reads=8, hybrid_sort=True)
    jcfg = JConfig(k=6, m=3, max_read_len=32, batch_reads=8, pallas_sort=True)
    table, _ = CountPipeline(tcfg, device="cpu").count_reads(_reads())
    tckpt.save_counted_table(tmp_path / "port.npz", table, tcfg, phase="post-count")
    jtable, jcfg_back, phase = jckpt.load_counted_table(str(tmp_path / "port.npz"))
    assert jcfg_back == jcfg and phase == "post-count"
    ours = convert.counted_table_to_lanes(table)
    for name, a, b in zip(FIELDS, jtable, ours):
        assert a.dtype == b.dtype and np.array_equal(a, b), name

    jckpt.save_counted_table(str(tmp_path / "jax.npz"), jtable, jcfg, phase="post-prune")
    back, tcfg_back, phase = tckpt.load_counted_table(tmp_path / "jax.npz")
    assert tcfg_back == tcfg and phase == "post-prune"
    for name in table._fields:
        assert torch.equal(getattr(back, name), getattr(table, name)), name
    # a JAX config with the fused scan on still loads (the port always scans on the card)
    jckpt.save_counted_table(str(tmp_path / "scan.npz"), jtable,
                             dataclasses.replace(jcfg, pallas_scan=True), phase="p")
    assert tckpt.load_counted_table(tmp_path / "scan.npz")[1] == tcfg


def test_stream_lane_past_2_32_is_written_whole(tmp_path):
    cfg = TConfig(k=6, m=3, max_read_len=32, batch_reads=8)
    table, _ = CountPipeline(cfg, device="cpu").count_reads(_reads())
    far = table._replace(stream_idx=table.stream_idx + (1 << 32))
    tckpt.save_counted_table(tmp_path / "far.npz", far, cfg, phase="p")
    assert np.load(tmp_path / "far.npz")["stream_idx"].dtype == np.int64
    assert torch.equal(tckpt.load_counted_table(tmp_path / "far.npz")[0].stream_idx,
                       far.stream_idx)
    tckpt.save_counted_table(tmp_path / "near.npz", table, cfg, phase="p")
    assert np.load(tmp_path / "near.npz")["stream_idx"].dtype == np.uint32


def _fast_reads(tmp_path):
    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=1500, read_len=60, coverage=6, seed=3, with_reverse=True)
    path = tmp_path / "fast.txt"
    datagen.write_reads(reads, str(path))
    return path


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_both_clis_count_checkpoints_agree(tmp_path, capsys, mode):
    if mode == "parity":
        args = [str(GOLDEN / "input.txt"), "--k", "6", "--m", "3", "--max-read-len", "32",
                "--batch-reads", "8"]
    else:
        args = [str(_fast_reads(tmp_path)), "--mode", "fast", "--k", "21", "--m", "7",
                "--batch-reads", "32"]
    for name, cli in (("jax", jcli), ("port", tcli)):
        assert cli.main(["count", *args, "--cpu", "--checkpoint", str(tmp_path / name),
                         "--metrics", str(tmp_path / f"{name}.jsonl")]) == 0
    err = capsys.readouterr().err.splitlines()
    entries = [line for line in err if line.startswith("entries:")]
    assert len(entries) == 2 and entries[0] == entries[1]
    want, jcfg, jphase = jckpt.load_counted_table(str(tmp_path / "jax.npz"))
    got, tcfg, tphase = tckpt.load_counted_table(tmp_path / "port.npz")
    _same_tables(want, convert.counted_table_to_lanes(got))
    assert jphase == tphase == "post-count"
    assert json.loads((tmp_path / "port.meta.json").read_text())["config"] == json.loads(
        (tmp_path / "jax.meta.json").read_text())["config"]
    recs = [json.loads((tmp_path / f"{name}.jsonl").read_text()) for name in ("jax", "port")]
    for rec in recs:
        rec.pop("ts"), rec.pop("wall_s"), rec.pop("run")
    # the port's record ends with the run's own record of itself
    own = [recs[1].pop(f) for f in ("phase_s", "spans_s", "counts")]
    assert list(own[0]) == ["batch", "scan", "count"] and own[2]["h2d_bytes"] > 0
    assert recs[0] == recs[1] and recs[0]["event"] == "count"

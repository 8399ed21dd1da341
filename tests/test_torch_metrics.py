"""Port vs JAX package: JSONL metrics (utils/metrics.py) and the CLI's
``assemble --metrics`` (CPU).

``MetricsLogger`` records equal the JAX package's key for key and in
order, ``ts`` and ``wall_s`` left out (clock readings); both CLIs'
``assemble --metrics --cpu`` write one ``assemble`` record with the same
fields and counts, in parity mode on the goldens' input (k 6, m 3) and in
fast mode on a generated read set; the port's record then carries the
run's ``phase_s``, ``spans_s`` and ``counts``.
"""

import io
import json
import pathlib

import pytest

from genome_assembly_tpu import cli as jcli
from genome_assembly_tpu.utils import metrics as jmetrics
from genome_assembly_tpu_torch import cli as tcli
from genome_assembly_tpu_torch.io import datagen
from genome_assembly_tpu_torch.utils import metrics as tmetrics

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


def _records(module, path=None):
    sink = io.StringIO()
    log = module.MetricsLogger(sink, run_id="t")
    with log.phase("count", k=31, m=7) as extra:
        extra["entries"] = 42
        extra["nested"] = {"a": [1, 2]}
    log.emit("done", ok=True)
    with pytest.raises(ValueError):
        with log.phase("failing", k=1):
            raise ValueError("inside a phase")
    returned = log.emit("last", n=3)
    recs = [json.loads(line) for line in sink.getvalue().splitlines()]
    assert recs[-1] == returned
    return recs


def test_metrics_logger_records_match_jax():
    want, got = _records(jmetrics), _records(tmetrics)
    assert len(got) == len(want) == 4
    for w, g in zip(want, got):
        assert list(g) == list(w)  # same keys, same order
        assert list(g)[:3] == ["ts", "run", "event"]
        for rec in (w, g):
            rec.pop("ts")
            rec.pop("wall_s", None)
        assert g == w
    assert got[0] == {"run": "t", "event": "count", "k": 31, "m": 7, "entries": 42,
                      "nested": {"a": [1, 2]}}
    assert got[2]["event"] == "failing"  # a phase that raised still emits


def test_open_metrics(tmp_path):
    path = tmp_path / "m.jsonl"
    for _ in range(2):  # appends
        log = tmetrics.open_metrics(str(path), run_id="r")
        log.emit("e", x=1)
        log.sink.close()
    assert [json.loads(line)["run"] for line in path.read_text().splitlines()] == ["r", "r"]
    assert tmetrics.open_metrics(None).sink is None
    assert tmetrics.open_metrics(None).emit("e")["event"] == "e"


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_both_clis_assemble_metrics_agree(tmp_path, capsys, mode):
    if mode == "parity":
        args = [str(GOLDEN / "input.txt"), "--k", "6", "--m", "3"]
        fields = ["entries_pre_prune", "n_reads", "n_windows"]
    else:
        _, reads, _ = datagen.generate_coverage_reads(
            genome_len=1500, read_len=60, coverage=6, seed=3, with_reverse=True)
        datagen.write_reads(reads, str(tmp_path / "r.txt"))
        args = [str(tmp_path / "r.txt"), "--mode", "fast", "--k", "21", "--m", "7"]
        fields = ["entries_post_prune", "n_unitigs", "n_windows"]
    outs = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        assert cli.main(["assemble", *args, "--cpu",
                         "--metrics", str(tmp_path / f"{name}.jsonl")]) == 0
        outs[name] = capsys.readouterr().out
    assert outs["jax"] == outs["port"] and outs["port"]
    recs = {}
    for name in ("jax", "port"):
        (line,) = (tmp_path / f"{name}.jsonl").read_text().splitlines()
        recs[name] = json.loads(line)
    # the port's record ends with the run's own record of itself
    own = {f: recs["port"].pop(f) for f in ("phase_s", "spans_s", "counts")}
    assert list(recs["port"]) == list(recs["jax"]) == [
        "ts", "run", "event", "wall_s", "mode", "k", "m", *fields]
    assert own["phase_s"] and all(v > 0 for v in own["counts"].values())
    assert set(own["counts"]) == ({"h2d_bytes", "d2h_bytes"} if mode == "fast"
                                  else {"h2d_bytes"})
    for rec in recs.values():
        rec.pop("ts"), rec.pop("wall_s"), rec.pop("run")
    assert recs["port"] == recs["jax"]
    assert recs["port"]["event"] == "assemble" and recs["port"]["mode"] == mode
    assert all(recs["port"][f] > 0 for f in fields)

"""Reads of up to 256 bases on the port's fast path, and the run's scan and
staging counters, exactly.

150-bp reads at 100x go into rows of 256 bases (``max_read_len`` 256, as
``assemble --mode fast --max-read-len 256`` runs them), in core and out of
core; reads of 31 to 256 bases cross the boundaries of the scan kernel's
rounds of 128 bases.  On the CPU the port is held to the JAX package: the
same unitigs in the same order and the same ``PhaseStats`` counters.  The
``card`` cases run the same reads on a CUDA card, where the kernel itself
scans, held to the plain reference of ``gabench/reference`` (all four
numbers of mismatches 0), and skip without one.  On a card (this file
imports JAX only in its CPU cases):

    python -m pytest tests/test_torch_long_reads.py --noconftest -m card -q
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from genome_assembly_tpu_torch import cli
from genome_assembly_tpu_torch.config import PipelineConfig
from genome_assembly_tpu_torch.models.pipeline import FastAssembler
from genome_assembly_tpu_torch.ops import outofcore

K = 31
ROW = 256
N_WIN = ROW - K + 1
BATCH = 2048
SEEDS = [2**31 + 19, 7, 4_000_000_007]
# 150-bp reads of an 8 kb genome at 100x: 5,334 reads in 3 batches, the
# last padded; 1,388,544 slots, 11.1 MB of keys, so 4 MiB counts out of
# core in ceil(11.1 / (4.19 / 3)) = 8 partitions
N_BATCHES, PARTITIONS = 3, 8
OUT_OF_CORE = 4 << 20
IN_CORE = 3 << 30
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.card)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device(request.param)


@functools.lru_cache(maxsize=None)
def made(seed: int, read_len: int = 150, genome_len: int = 8_000, coverage: int = 100,
         repeat: tuple = (500, 7)) -> np.ndarray:
    """Reads of a random genome holding ``repeat`` (length, copies), each
    copy on a random strand: uniform starts at ``coverage``, half of them
    reverse-complemented, 0.1 % substitutions.  A (reads, read_len) array
    of the letters' bytes."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len)
    length, copies = repeat
    unit = rng.integers(0, 4, size=length)
    for start in rng.integers(0, genome_len - length + 1, size=copies):
        genome[start:start + length] = unit if rng.random() < 0.5 else 3 - unit[::-1]
    n_reads = -(-genome_len * coverage // read_len)
    starts = rng.integers(0, genome_len - read_len + 1, size=n_reads)
    codes = genome[starts[:, None] + np.arange(read_len)]
    flip = rng.random(n_reads) < 0.5
    codes[flip] = 3 - codes[flip, ::-1]
    errors = rng.random(codes.shape) < 0.001
    codes[errors] = (codes[errors] + rng.integers(1, 4, size=int(errors.sum()))) % 4
    return BASES[codes]


def as_strings(chars):
    return [row.tobytes().decode() for row in chars]


def config(outofcore_bytes=IN_CORE):
    return dict(k=K, m=4, abundance_cutoff=1, parity=False, batch_reads=BATCH,
                max_read_len=ROW, outofcore_bytes=outofcore_bytes)


def counters(stats):
    """The counters both packages keep (the JAX ``PhaseStats`` has no
    ``spans_s`` or ``counts``)."""
    d = dataclasses.asdict(stats)
    for clock_reading in ("wall_s", "spans_s", "counts"):
        d.pop(clock_reading, None)
    return d


def assemble(chars, device, outofcore_bytes=IN_CORE):
    """(reads as strings, unitigs, stats) of the port."""
    loaded = as_strings(chars)
    out, stats = FastAssembler(PipelineConfig(**config(outofcore_bytes)),
                               device=device).unitigs(loaded)
    return loaded, out, stats


def held_to_the_oracle(chars, loaded, out, stats, device, outofcore_bytes=IN_CORE):
    """On the CPU: the JAX package's unitigs in the same order, and its
    counters.  On a card, where JAX is not: the plain reference's four
    numbers of mismatches, all 0."""
    if device.type == "cpu":
        from genome_assembly_tpu.config import PipelineConfig as JConfig
        from genome_assembly_tpu.models.pipeline import FastAssembler as JFast

        want, wstats = JFast(JConfig(**config(outofcore_bytes))).unitigs(loaded)
        assert out == want
        assert counters(stats) == counters(wstats)
    else:
        from gabench.reference import dbg_unitigs as reference

        expected = reference.Expected(chars, {"k": K, "abundance_cutoff": 1}, device)
        judged = reference.judge(expected, loaded, out, device)
        assert judged == {name: 0 for name in reference.LIMITS}


@pytest.mark.parametrize("outofcore_bytes", [IN_CORE, OUT_OF_CORE], ids=["incore", "ooc"])
@pytest.mark.parametrize("seed", SEEDS)
def test_150bp_reads_at_100x_match_the_reference(device, seed, outofcore_bytes):
    chars = made(seed)
    loaded, out, stats = assemble(chars, device, outofcore_bytes)
    held_to_the_oracle(chars, loaded, out, stats, device, outofcore_bytes)
    assert len(out) > 1
    assert ("staged_bytes" in stats.counts) == (outofcore_bytes == OUT_OF_CORE)
    if outofcore_bytes == OUT_OF_CORE:
        assert stats.counts["partitions"] == PARTITIONS


@pytest.mark.parametrize("read_len", [31, 127, 128, 129, 150, 255, 256])
def test_read_lengths_across_the_scan_rounds_match_the_reference(device, read_len):
    chars = made(11, read_len, genome_len=5_000, coverage=50, repeat=(300, 3))
    loaded, out, stats = assemble(chars, device)
    held_to_the_oracle(chars, loaded, out, stats, device)
    assert stats.n_windows == len(chars) * (read_len - K + 1)


def test_in_core_counters_are_the_slots_and_windows_of_each_launch():
    chars = made(SEEDS[0])
    assert -(-len(chars) // BATCH) == N_BATCHES
    _, _, stats = assemble(chars, "cpu")
    assert stats.counts["slots"] == N_BATCHES * BATCH * N_WIN == 1_388_544
    assert stats.counts["windows"] == stats.n_windows == len(chars) * 120 == 640_080
    assert not {"staged_bytes", "partitions", "passes"} & set(stats.counts)


def out_of_core_plan():
    """(staging cap, partitions a pass) at the budget in force."""
    return outofcore.range_group_plan(
        N_BATCHES, BATCH * N_WIN, partitions=PARTITIONS, bytes_per_record=8,
        budget_bytes=outofcore.partitioned_count.__kwdefaults__["group_budget_bytes"])


def same_set_as_in_core(chars, out):
    _, incore, _ = assemble(chars, "cpu")
    assert sorted(out) == sorted(incore) and out


@pytest.mark.parametrize("passes", [1, 2])
def test_out_of_core_counters_hold_the_probe_each_pass_and_the_staging(monkeypatch, passes):
    chars = made(SEEDS[0])
    cap, _ = out_of_core_plan()
    if passes == 2:
        # room for 4 partitions a pass: 8 take two passes of 4 buffers each
        monkeypatch.setitem(outofcore.partitioned_count.__kwdefaults__, "group_budget_bytes",
                            4 * N_BATCHES * cap * 8)
    _, group = out_of_core_plan()
    assert (group, -(-PARTITIONS // group)) == ((8, 1) if passes == 1 else (4, 2))
    _, out, stats = assemble(chars, "cpu", OUT_OF_CORE)
    same_set_as_in_core(chars, out)
    counts = stats.counts
    assert (counts["partitions"], counts["passes"]) == (PARTITIONS, passes)
    # one probe of batch 0, then every batch again each pass
    assert counts["slots"] == (1 + passes * N_BATCHES) * BATCH * N_WIN
    assert counts["windows"] == BATCH * 120 + passes * len(chars) * 120
    assert counts["staged_bytes"] == passes * group * N_BATCHES * cap * 8
    # the slots, not the windows, as the JAX package's branch has them
    assert stats.n_windows == N_BATCHES * BATCH * N_WIN


def test_a_reextracted_partition_adds_its_keys_to_the_staging(monkeypatch):
    """Every partition's cap cut to a third, below a full batch's mean
    share: each overflows, and is re-extracted alone at twice that cap,
    above its share in any batch (one sweep of the batches each); the keys a
    re-extraction hands back are staged too, so they add every valid
    window once."""
    chars = made(SEEDS[1])
    cap, group = out_of_core_plan()
    plan = outofcore.range_group_plan

    def cut(*args, **kw):
        full, size = plan(*args, **kw)
        return full // 3, size

    assert 2 * (cap // 3) > BATCH * 120 // PARTITIONS > cap // 3
    monkeypatch.setattr(outofcore, "range_group_plan", cut)
    _, out, stats = assemble(chars, "cpu", OUT_OF_CORE)
    same_set_as_in_core(chars, out)
    counts = stats.counts
    assert counts["passes"] == 1
    windows = len(chars) * 120
    assert counts["staged_bytes"] == group * N_BATCHES * (cap // 3) * 8 + windows * 8
    assert counts["slots"] == (1 + N_BATCHES + PARTITIONS * N_BATCHES) * BATCH * N_WIN
    assert counts["windows"] == BATCH * 120 + (1 + PARTITIONS) * windows


def test_the_cli_names_the_flag_for_150bp_reads_and_assembles_them_at_256(tmp_path, capsys):
    """Refused at the default rows of 128 with an error that names the
    flag; assembled at rows of the reads' own length and at 256, both as
    the JAX package assembles them."""
    from genome_assembly_tpu.config import PipelineConfig as JConfig
    from genome_assembly_tpu.models.pipeline import FastAssembler as JFast

    chars = made(5, genome_len=3_000, coverage=20, repeat=(100, 1))
    path = tmp_path / "reads.txt"
    path.write_text("".join(f"{r}\n" for r in as_strings(chars)))
    args = ["assemble", str(path), "--mode", "fast", "--cpu"]
    with pytest.raises(ValueError, match="exceeds max_read_len=128") as refused:
        cli.main(args)
    message = str(refused.value)
    assert "--max-read-len" in message and "at least the longest read" in message
    assert "chunking path" not in message
    want, _ = JFast(JConfig(**config())).unitigs(as_strings(chars))
    assert want
    for rows in ("150", "256"):
        capsys.readouterr()
        assert cli.main(args + ["--max-read-len", rows]) == 0
        assert capsys.readouterr().out.split() == want

"""Port vs JAX package: the validation plots (utils/plots.py), the
generators (io/datagen.py) and the CLI's ``generate`` and ``plot`` (CPU).

``parse_verbose_output`` and ``placement_matrix_by_read_ids`` equal the JAX
package's on the goldens' verbose output; every plot writes a PNG, pixel
for pixel the JAX package's; ``generate_reads`` and ``reads_from_starts``
draw the JAX package's genome, starts and reads for several seeds; both
CLIs' ``generate --triangular`` files are byte-equal and ``plot`` writes the
same files.  Tolerance 0.
"""

import pathlib

import numpy as np
import pytest

from genome_assembly_tpu import cli as jcli
from genome_assembly_tpu.io import datagen as jdatagen
from genome_assembly_tpu.utils import plots as jplots
from genome_assembly_tpu_torch import cli as tcli
from genome_assembly_tpu_torch.io import datagen as tdatagen
from genome_assembly_tpu_torch.utils import plots as tplots

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _verbose():
    return (GOLDEN / "input_k6m3_verbose.txt").read_text()


def _golden_genome():
    """The goldens' reads laid end to end, each padded to the longest read
    with N: read r starts at r * width."""
    reads = (GOLDEN / "input.txt").read_text().split()
    width = max(map(len, reads))
    return "".join(r.ljust(width, "N") for r in reads), [r * width for r in range(len(reads))], width


def _pixels(path):
    from matplotlib import image

    data = pathlib.Path(path).read_bytes()
    assert data.startswith(PNG_MAGIC)
    return image.imread(str(path))


def test_parse_verbose_output_equals_jax():
    want = jplots.parse_verbose_output(_verbose())
    got = tplots.parse_verbose_output(_verbose())
    assert got == want
    bins, unitigs = got
    assert sum(bins.values()) == len(unitigs) == 61


def test_placement_matrix_by_read_ids_equals_jax():
    _, unitigs = tplots.parse_verbose_output(_verbose())
    genome, starts, width = _golden_genome()
    want = jplots.placement_matrix_by_read_ids(unitigs, starts, genome, width)
    got = tplots.placement_matrix_by_read_ids(unitigs, starts, genome, width)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # most unitigs are placed through their reads' windows
    assert 2 * int(got.any(axis=1).sum()) > len(unitigs)


def test_every_plot_writes_the_jax_png(tmp_path):
    bins, unitigs = tplots.parse_verbose_output(_verbose())
    genome, starts, width = _golden_genome()
    calls = {
        "reads": lambda p: p.plot_reads(starts, len(genome), width, "{}"),
        "mmers": lambda p: p.plot_mmer_bins(bins, "{}"),
        "placement": lambda p: p.plot_unitig_placement([u for u, _ in unitigs], genome, "{}"),
        "by_read_ids": lambda p: p.plot_unitig_placement_by_read_ids(
            unitigs, starts, genome, width, "{}"),
    }
    for name, call in calls.items():
        paths = {}
        for tag, module in (("jax", jplots), ("port", tplots)):
            paths[tag] = tmp_path / f"{name}_{tag}.png"

            class Fmt:  # substitutes the path into the call's last argument
                def __getattr__(self, attr, module=module, path=paths[tag]):
                    fn = getattr(module, attr)
                    return lambda *a: fn(*a[:-1], str(path))
            call(Fmt())
        assert np.array_equal(_pixels(paths["port"]), _pixels(paths["jax"])), name


@pytest.mark.parametrize("seed", [0, 7, 20, 12345])
def test_generate_reads_equals_jax(seed):
    kw = dict(genome_len=400 + seed % 97, read_len=25, read_num=30, seed=seed)
    genome, starts = tdatagen.generate_reads(**kw)
    assert (genome, starts) == jdatagen.generate_reads(**kw)
    assert len(genome) == kw["genome_len"] and len(starts) == 30
    reads = tdatagen.reads_from_starts(genome, starts, 25)
    assert reads == jdatagen.reads_from_starts(genome, starts, 25)
    assert all(len(r) == 25 for r in reads)
    other = tdatagen.generate_reads(**kw, genome_seed=seed + 1)
    assert other == jdatagen.generate_reads(**kw, genome_seed=seed + 1)
    assert other[0] != genome and other[1] == starts


def _cli_files(cli, outdir, args):
    outdir.mkdir()
    assert cli.main(args(outdir)) == 0
    return {p.name: p for p in sorted(outdir.iterdir())}


def test_cli_generate_triangular_files_are_byte_equal(tmp_path):
    def args(d):
        return ["generate", "--triangular", "--genome-len", "300", "--read-len", "30",
                "--read-num", "25", "--seed", "9", "--out", str(d / "reads.txt"),
                "--genome-out", str(d / "genome.txt"), "--starts-out", str(d / "starts.txt"),
                "--plot", str(d / "reads.png")]

    want = _cli_files(jcli, tmp_path / "jax", args)
    got = _cli_files(tcli, tmp_path / "port", args)
    assert list(got) == list(want) == ["genome.txt", "reads.png", "reads.txt", "starts.txt"]
    for name in ("genome.txt", "reads.txt", "starts.txt"):
        assert got[name].read_bytes() == want[name].read_bytes(), name
    assert np.array_equal(_pixels(got["reads.png"]), _pixels(want["reads.png"]))
    assert len(got["reads.txt"].read_text().split()) == 25


@pytest.mark.parametrize("with_starts", [False, True])
def test_cli_plot_writes_the_jax_files(tmp_path, with_starts):
    genome, starts, width = _golden_genome()
    (tmp_path / "genome.txt").write_text(genome + "\n")
    (tmp_path / "starts.txt").write_text("\n".join(map(str, starts)) + "\n")
    extra = ["--starts-file", str(tmp_path / "starts.txt"), "--read-len", str(width)] \
        if with_starts else []

    def args(d):
        return ["plot", str(GOLDEN / "input_k6m3_verbose.txt"), "--genome-file",
                str(tmp_path / "genome.txt"), "--outdir", str(d), *extra]

    want = _cli_files(jcli, tmp_path / "jax", args)
    got = _cli_files(tcli, tmp_path / "port", args)
    assert list(got) == list(want) == ["kmers.png", "mmers.png"]
    for name in got:
        assert np.array_equal(_pixels(got[name]), _pixels(want[name])), name

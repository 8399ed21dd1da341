"""Port vs JAX package: the checkpoints of the out-of-core parity count
(``ops/outofcore.partitioned_count_parity(checkpoint_dir=, dataset_tag=)``,
CPU).

The same numpy-seeded parity lanes go through both packages.  A run with a
checkpoint directory equals one without; a directory with some part files
deleted resumes to the same table; a directory written by either package
resumes in the other, with and without streams; a directory of another
fingerprint raises.  Integers: tolerance 0.
"""

import json

import numpy as np
import pytest

from genome_assembly_tpu.ops import outofcore as jooc
from genome_assembly_tpu_torch import convert
from genome_assembly_tpu_torch.ops import outofcore as tooc

from test_torch_outofcore import _parity_batch, _same_host

N_BATCHES, N, PARTITIONS = 3, 96, 5
KW = dict(partitions=PARTITIONS, cutoff=-1)
PAIRS = [_parity_batch(b, N) for b in range(N_BATCHES)]


def _port(ckpt=None, with_streams=False, made=None, **kw):
    def records(b):
        if made is not None:
            made.append(b)
        return PAIRS[b][1]
    return tooc.partitioned_count_parity(records, N_BATCHES, checkpoint_dir=ckpt,
                                         with_streams=with_streams, **dict(KW, **kw))


def _jax(ckpt=None, with_streams=False, made=None, **kw):
    def records(b):
        if made is not None:
            made.append(b)
        return PAIRS[b][0]
    return jooc.partitioned_count_parity(records, N_BATCHES, checkpoint_dir=ckpt,
                                         with_streams=with_streams, **dict(KW, **kw))


def _same(a, b, with_streams):
    """Two port results, array for array."""
    for name in ("mmer", "kmer", "count", "first_seen"):
        x, y = getattr(a[0], name), getattr(b[0], name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    lists = [(a[0].read_ids, b[0].read_ids)] + ([(a[1], b[1])] if with_streams else [])
    for xs, ys in lists:
        assert len(xs) == len(ys)
        assert all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(xs, ys))
    assert a[-2:] == b[-2:]


def _same_as_jax(want, got, with_streams):
    _same_host(want[0], got[0])
    if with_streams:
        assert len(got[1]) == len(want[1])
        assert all(np.array_equal(x, y) for x, y in zip(got[1], want[1]))
    assert got[-2:] == want[-2:]


@pytest.mark.parametrize("with_streams", [False, True])
def test_checkpointed_run_equals_a_plain_run_and_resumes(tmp_path, with_streams):
    plain = _port(with_streams=with_streams)
    first = _port(tmp_path, with_streams=with_streams)
    _same(first, plain, with_streams)
    parts = sorted(tmp_path.glob("part_*_parity.npz"))
    assert len(parts) == PARTITIONS
    assert json.loads((tmp_path / "meta_parity.json").read_text()) == {
        "format": 2, "scheme": "range16", "mode": "parity", "partitions": PARTITIONS,
        "cutoff": -1, "n_batches": N_BATCHES, "batch_slots": N}
    # every part there: no pass, only the probe of the batch width
    made = []
    _same(_port(tmp_path, with_streams=with_streams, made=made), plain, with_streams)
    assert made == [0]
    # half the parts deleted: their groups pass again, the rest loads
    for p in parts[::2]:
        p.unlink()
    made = []
    _same(_port(tmp_path, with_streams=with_streams, made=made), plain, with_streams)
    assert len(made) > 1 and len(list(tmp_path.glob("part_*_parity.npz"))) == PARTITIONS


def test_part_files_hold_the_jax_lanes(tmp_path):
    _port(tmp_path, with_streams=True)
    with np.load(tmp_path / "part_0_parity.npz") as saved:
        dtypes = {name: saved[name].dtype for name in saved.files}
    assert dtypes == {"mmer": np.uint32, "khi": np.uint32, "klo": np.uint32,
                      "count": np.int32, "first": np.uint32, "flat_ids": np.uint32,
                      "flat_streams": np.uint32, "overflows": np.int64}
    assert int(np.load(tmp_path / "windows_parity.npy")) == _port()[-2]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("with_streams", [False, True])
def test_directories_resume_across_packages(tmp_path, writer, with_streams):
    """A directory written by one package, resumed by the other with no
    pass, equals the JAX package's fresh count."""
    want = _jax(with_streams=with_streams)
    if writer == "jax":
        _jax(tmp_path, with_streams=with_streams, dataset_tag="d")
        made = []
        got = _port(tmp_path, with_streams=with_streams, made=made, dataset_tag="d")
        assert made == [0]
        _same_as_jax(want, got, with_streams)
    else:
        _port(tmp_path, with_streams=with_streams, dataset_tag="d")
        made = []
        got = _jax(tmp_path, with_streams=with_streams, made=made, dataset_tag="d")
        assert made == [0]
        # the JAX package's resumed table, through convert, against its fresh one
        _same_as_jax(want, (convert.host_table_from_lanes(*got[0]), *got[1:]), with_streams)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_parts_without_streams_are_counted_again_for_streams(tmp_path, writer):
    (_jax if writer == "jax" else _port)(tmp_path)
    made = []
    got = _port(tmp_path, with_streams=True, made=made)
    assert len(made) > 1
    _same_as_jax(_jax(with_streams=True), got, True)
    with np.load(tmp_path / "part_1_parity.npz") as saved:
        assert "flat_streams" in saved.files


def test_stream_lanes_past_2_32_are_written_whole(tmp_path):
    """First-seen and stream indices past 2^32 - 1 do not fit the JAX
    lane: the part file holds them as int64 and a resume reads them back
    whole."""
    big = 1 << 33
    pairs = [(j, (t[0], t[1], t[2], t[3] + big)) for j, t in PAIRS]

    def run(made=None):
        def records(b):
            if made is not None:
                made.append(b)
            return pairs[b][1]
        return tooc.partitioned_count_parity(records, N_BATCHES, checkpoint_dir=tmp_path,
                                             with_streams=True, **KW)
    first = run()
    with np.load(tmp_path / "part_0_parity.npz") as saved:
        assert saved["first"].dtype == np.int64 and int(saved["first"].min()) >= big
        assert saved["flat_streams"].dtype == np.int64
    made = []
    _same(run(made), first, True)
    assert made == [0]


def test_a_directory_of_another_fingerprint_raises(tmp_path):
    _port(tmp_path, dataset_tag="a")
    for kw in (dict(dataset_tag="b"), dict(dataset_tag="a", cutoff=1),
               dict(dataset_tag="a", partitions=PARTITIONS + 1)):
        with pytest.raises(ValueError, match="different parity configuration"):
            _port(tmp_path, **kw)
    with pytest.raises(ValueError):
        _jax(tmp_path, dataset_tag="b")

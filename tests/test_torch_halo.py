"""Port vs JAX package: the halo exchange (``parallel/halo.py``).

A numpy-seeded genome is split over 8 shards; the port's haloed segments
(a one-process CPU mesh, flat and (2, 2, 2)) equal JAX's ``haloed_segments``
on the conftest's 8 virtual devices, byte for byte, and the windows the
shards scan cover the genome's windows exactly once.  Also the mesh's
``ppermute``.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genome_assembly_tpu.ops import encode as jencode
from genome_assembly_tpu.parallel import halo as jhalo
from genome_assembly_tpu.parallel import mesh as jmesh_lib
from genome_assembly_tpu_torch.parallel import halo as thalo
from genome_assembly_tpu_torch.parallel import mesh as tmesh_lib
from genome_assembly_tpu_torch.tools import run_multihost


def _genome(size, seed=4):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list("ACGT"), size=size))


@pytest.mark.parametrize("shape", [(8,), (2, 2, 2)])
@pytest.mark.parametrize("k,size", [(11, 1000), (21, 997), (5, 83)])
def test_haloed_segments_equal_jax_and_cover_every_window_once(shape, k, size):
    genome = _genome(size, seed=k)
    codes = jencode.encode_str(genome)
    segments, lens = thalo.split_sequence(codes, 8, k)
    jseg, jlens = jhalo.split_sequence(codes, 8, k)
    np.testing.assert_array_equal(segments, jseg)
    np.testing.assert_array_equal(lens, jlens)
    want, want_lens = jhalo.haloed_segments(jnp.asarray(jseg), jnp.asarray(jlens), k=k,
                                            mesh=jmesh_lib.make_mesh(8))
    tm = tmesh_lib.make_mesh(devices=["cpu"], shape=shape)
    ext, ext_lens = thalo.haloed_segments(torch.from_numpy(segments), torch.from_numpy(lens),
                                          k=k, mesh=tm)
    got = tm.to_host(ext).reshape(8, -1)
    got_lens = tm.to_host(ext_lens).reshape(8)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got_lens, np.asarray(want_lens))
    windows = []
    for s in range(8):
        seg = got[s, :got_lens[s]]
        windows += [jencode.decode_str(seg[i:i + k]) for i in range(len(seg) - k + 1)]
    assert sorted(windows) == sorted(genome[i:i + k] for i in range(len(genome) - k + 1))


def test_ppermute_sends_along_an_axis_and_zeros_the_rest():
    tm = tmesh_lib.make_mesh(devices=["cpu"], shape=(2, 4))
    xs = [torch.full((2,), g + 1) for g in range(8)]
    # along the shard axis, each to its right neighbour, the last to none
    got = tm.ppermute(xs, [(i, i + 1) for i in range(3)], axes="shards")
    assert [int(x[0]) for x in got] == [0, 1, 2, 3, 0, 5, 6, 7]
    # along the slice axis, a swap
    got = tm.ppermute(xs, [(0, 1), (1, 0)], axes="slices")
    assert [int(x[0]) for x in got] == [5, 6, 7, 8, 1, 2, 3, 4]


WORKER = r"""
import json, sys
import numpy as np
import torch
from genome_assembly_tpu_torch.parallel import distributed, halo
rank, port = int(sys.argv[1]), int(sys.argv[2])
torch.set_num_threads(1)
distributed.init_multi_host(f"127.0.0.1:{port}", 4, rank, device="cpu")
mesh = distributed.global_mesh("cpu", shape=(2, 2))
seq = np.random.default_rng(7).integers(0, 4, size=203).astype(np.uint8)
segments, lens = halo.split_sequence(seq, 4, 11)
(ext,), (ext_len,) = halo.haloed_segments(segments, lens, k=11, mesh=mesh)
(shifted,) = mesh.ppermute([torch.tensor([rank + 1])], [(0, 1)], axes="slices")
print(json.dumps({"ext": ext.tolist(), "len": ext_len.tolist(), "shifted": shifted.tolist()}))
"""


def test_distributed_halo_and_ppermute_equal_the_one_process_mesh(tmp_path):
    """Four gloo processes as a (2, 2) mesh: the haloed segments equal the
    one-process mesh's, and a ppermute along the slice axis reaches only
    its destinations (the rest get zeros)."""
    port = run_multihost._free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = str(run_multihost.REPO_ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    seq = np.random.default_rng(7).integers(0, 4, size=203).astype(np.uint8)
    segments, lens = thalo.split_sequence(seq, 4, 11)
    tm = tmesh_lib.make_mesh(4, devices=["cpu"])
    ext, ext_lens = thalo.haloed_segments(segments, lens, k=11, mesh=tm)
    assert [o["ext"] for o in outs] == [e.tolist() for e in ext]
    assert [o["len"] for o in outs] == [e.tolist() for e in ext_lens]
    assert [o["shifted"] for o in outs] == [[0], [0], [1], [2]]

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py            # every phase, needs one CUDA device
    python3 chip_smoke.py --against DIR
                                     # only: K1, K3c, K4a and K5 of this tree
                                     # and of the copy of csrc/ in DIR
                                     # (another commit's), in turns

Builds the port's CUDA kernels from genome_assembly_tpu_torch/csrc/, holds
each kernel against its plain tensor version on the card (bit-exact: all
results on this path are integers), runs parity mode in core through
``ParityAssembler`` (the C++ replay engine built with g++ beside the kernels;
no kernel of csrc/ is on that path): the input of the ``input_k6m3`` goldens
byte for byte (``parity_golden``), BASELINE.md's big run on the card, clean
and with non-ACGT bytes, its groups held against the CPU's (``parity_e2e``,
``parity_dirty``), and
the count of the largest in-core parity read set (``parity_scale``), then runs
fast-mode in-core assembly end to
end through ``FastAssembler.unitigs`` at a small size (card vs CPU) and at
the size of the repo's ``ecoli`` scale preset -- once with the default
library sort (``full_e2e``), then through the CLI with ``--trace`` and
``--metrics`` beside the other one-device surfaces (``surfaces_e2e``: the
trace's device busy share by phase, ``count --checkpoint`` on BASELINE.md's
big run, the threaded feeder, the parity out-of-core checkpoints resumed,
the ``entry()`` step card == CPU), and once with ``hybrid_sort=True``, the count
sort through the bitonic kernels (``hybrid_e2e``; same reads, the results
must be equal; the scan phase must read back from the card once) -- drives
the sort entry points no pipeline calls
(``sort_rows``, ``sort_keys``, and ``sort_keys_mergepath`` on random keys and
on the ecoli reads' own scanned keys) at the main path's key count, times every kernel beside its plain
version, its bound and the library call, measures the grids behind the sorts'
defaults (``chunk_choice``, ``tile_choice``, ``rows_choice``), and runs both
assemblers out of core: fast mode at the default limits on a 10 Mb genome at
50x with errors (``ooc_e2e``) and with every switch thrown on the ecoli reads
(``ooc_extension``: partitioned count, out-of-core links, bulk jump, device
materializer; also with ``hybrid_sort``), parity mode on the goldens' input
(``parity_ooc_golden``) and at the default limits on a 2 Mb genome plus
BASELINE.md's big run forced out of core (``parity_ooc_scale``), each held
against an in-core run of the same reads; drives the genome-scale runner
(``genome_assembly_tpu_torch/tools/run_scale.py``, reads made on the card):
its functions on the ecoli preset (``scale_checks``: super-k-mer and plain
out-of-core counts, card == CPU, forced subrange counts, worker ranges merged
from one checkpoint directory, a killed jump resumed, parked links, the
bucketed materializer) and its chr1 rehearsal at full size, 250 Mb x 30x,
7,360,217,088 window slots (``scale_chr1``); drives the multi-device path
(``mesh_e2e``): ``FastAssembler.unitigs(mesh=)`` over 4 shards on the card
(or one a card) on the ecoli reads, held against ``full_e2e``'s list, K1
once a shard; the ragged count of the same reads; ``ParityAssembler`` over
the mesh on the goldens' input and BASELINE.md's big run; and
``tools/run_multihost.py`` over several processes (NCCL, and gloo on one
card), held against the one-process mesh, launched beside ``mesh2_e2e``'s
process checks; holds K5, the lane gather of the JAX primitive probe, against
its plain version and ``torch.gather`` (``kernel_check``) and runs the port's
probe (``prims``); holds the communication model's exchange matrices to the
sharded count, the links join and the routed jump on the ecoli reads and
measures the rates behind its constants (``comm_model``); runs the runner's
``--ext-mode bulk|part`` at the ecoli preset against each other
(``ext_modes``); sets the parked-links model's budget beside chr1's measured
links wall (``scale_chr1``); and prints one JSON object per phase.  Exits non-zero if there is no CUDA device, if the
package cannot be imported (run it from the root of a checkout) or if any
phase fails.  Imports nothing of JAX and nothing of the JAX package.  A
second run in the same checkout reuses the built libraries and their
build logs.

Last three lines of standard output: the card's name and power limit as
nvidia-smi gives them, the ``kernels`` report, and the verdict.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import io
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import warnings

import numpy as np
import torch

try:
    from genome_assembly_tpu_torch import cli, convert
    from genome_assembly_tpu_torch import entry as entry_mod
    from genome_assembly_tpu_torch.common import SENTINEL
    from genome_assembly_tpu_torch.config import PipelineConfig
    from genome_assembly_tpu_torch.csrc import build as csrc_build
    from genome_assembly_tpu_torch.io import datagen
    from genome_assembly_tpu_torch.io import reads as reads_io
    from genome_assembly_tpu_torch.io import stream as stream_io
    from genome_assembly_tpu_torch.models import pipeline
    from genome_assembly_tpu_torch.models.pipeline import (
        CountPipeline, FastAssembler, ParityAssembler, PhaseStats)
    from genome_assembly_tpu_torch.native import build as native_build
    from genome_assembly_tpu_torch.native import replay_native
    from genome_assembly_tpu_torch.ops import bitonic_cuda
    from genome_assembly_tpu_torch.ops import bitonic_sort
    from genome_assembly_tpu_torch.ops import count as count_ops
    from genome_assembly_tpu_torch.ops import dbg
    from genome_assembly_tpu_torch.ops import lane_gather
    from genome_assembly_tpu_torch.ops import lane_gather_cuda
    from genome_assembly_tpu_torch.ops import mergepath_cuda
    from genome_assembly_tpu_torch.ops import mergepath_sort
    from genome_assembly_tpu_torch.ops import minimizer
    from genome_assembly_tpu_torch.ops import minimizer_cuda
    from genome_assembly_tpu_torch.ops import outofcore
    from genome_assembly_tpu_torch.ops import superkmer
    from genome_assembly_tpu_torch.parallel import comm_model
    from genome_assembly_tpu_torch.parallel import mesh as mesh_lib
    from genome_assembly_tpu_torch.parallel import part_dbg
    from genome_assembly_tpu_torch.parallel import shard_count
    from genome_assembly_tpu_torch.parallel import two_level
    from genome_assembly_tpu_torch.parity import nonacgt
    from genome_assembly_tpu_torch.parity import table as parity_table
    from genome_assembly_tpu_torch.tools import bench_prims
    from genome_assembly_tpu_torch.tools import bench_scaling_model
    from genome_assembly_tpu_torch.tools import run_multihost
    from genome_assembly_tpu_torch.tools import run_multihost_ckpt
    from genome_assembly_tpu_torch.tools import run_scale
    from genome_assembly_tpu_torch.utils import checkpoint as checkpoint_io
except ImportError as missing:
    # the run fails all the same; it says why instead of failing in silence
    sys.exit(f"chip_smoke: cannot import {missing.name} (looked for the package "
             f"genome_assembly_tpu_torch in {pathlib.Path(__file__).resolve().parent} "
             f"and on sys.path): {missing}. Run it from the root of a checkout of the repo.")

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate,
# and the float32 rate outside the tensor cores, taken here as the peak for
# 32-bit integer ALU operations (the data sheet gives no integer rate).
PEAK_BYTES_PER_S = 3.35e12
PEAK_ALU_OPS_PER_S = 67e12

# The repo's `ecoli` scale preset (tools/run_scale.py), M as in bench.py.
ECOLI = dict(genome_len=4_600_000, coverage=50, read_len=100, k=31, m=7,
             batch_reads=65536, max_read_len=128, cutoff=1)

# Parity mode at the shape the reference itself was measured at (a 100 kb
# genome at 50x, 100-bp lines, K=31, M=4; BASELINE.md's big run, which
# tools/run_parity_soak.py reproduces), and its largest in-core read set by
# the 20-bytes-a-slot threshold the JAX package uses: a 1 Mb genome at 50x.
PARITY_E2E = dict(genome_len=100_000, coverage=50, read_len=100, seed=7,
                  k=31, m=4, cutoff=1, max_read_len=128, batch_reads=16384)
PARITY_SCALE = dict(PARITY_E2E, genome_len=1_000_000, batch_reads=65536)

# Out of core at the DEFAULT limits (3 GiB of records): a 10 Mb genome at
# 50x with 0.1 % substitution errors in fast mode (77 batches of 65536 x 128,
# 494,534,656 window slots = 3.96 GB of keys: 4 partitions), and a 2 Mb
# genome at 50x in parity mode (2,000,000 read ids through fgets(101), 31
# batches of 65536, 199,098,368 slots = 3.98 GB at the JAX package's 20 B a
# slot: 4 partitions).  The in-core runs they are held against raise
# outofcore_bytes to 8 GiB.
OOC_E2E = dict(ECOLI, genome_len=10_000_000, error_rate=0.001, seed=1)
PARITY_OOC_SCALE = dict(PARITY_E2E, genome_len=2_000_000, batch_reads=65536)
INCORE_BYTES = 8 << 30
# every out-of-core switch of fast mode thrown on the ecoli preset: 11 count
# partitions, 7 link partitions, the bulk jump
OOC_EXTENSION_LIMITS = dict(outofcore_bytes=512 << 20, link_budget_bytes=32 << 20,
                            bulk_jump_states=1 << 20)
# BASELINE.md's big run forced out of core: 224.8 MB at 20 B a slot clean,
# 192.7 MB with the --dirty corruption (its joined lines make fewer read ids)
BIG_RUN_OOC_BYTES = 150_000_000
GOLDEN = pathlib.Path(__file__).resolve().parent / "tests" / "golden"

KERNEL_SHAPE = (65536, 128)
# rows a slice of the plain scan takes when a kernel is held against it
PLAIN_ROWS = 131072
# rows of one expansion chunk of the super-k-mer count (its default
# expand_chunk), each S_CAP + k - 1 = 55 bases at k = 31
EXPAND_ROWS = 1 << 20
# the genome-scale runner's phases: its functions on the ecoli preset, and
# its chr1 rehearsal at full size (250 Mb x 30x, 573 batches of 131072 x 128)
SCALE_CHECK_PRESET = "ecoli"
SCALE_CHR1_ARGS = ["--preset", "chr1", "--super", "--park-keys", "--park-links",
                   "--materialize"]
CHR1_SLOTS = 7_360_217_088
CHR1_BATCH = 131072
# its parked links' plan (every chr1 run's link_pass events): 30 chunks of 2^23
# nodes, 12 partitions
CHR1_LINK_CHUNKS = 30
CHR1_LINK_PARTITIONS = 12
# the SUB_COUNT_SLOTS that forces the ecoli super partitions into more
# subranges than the default's (4 partitions of about 4.6 M records: 8
# chunks of 2^20, 209.7 M expanded slots; 2 subranges at 192 << 20, 5 here)
FORCED_SUB_COUNT_SLOTS = 40 << 20
# shapes the row sort is timed at: 2^26 keys (where it is driven too), and
# what the chunk sorts do on 2^28 keys, as rows
ROWS_SHAPE = (16384, 4096)
SQUARE_ROWS_SHAPE = (1 << 14, 1 << 14)
# the mesh path: 4 shards, on the one card or one a card; the processes of
# run_multihost.py on a 200 kb genome at 20x with the ecoli preset's k and m
MESH_SHARDS = 4
# one shard's rows of the ecoli reads as one batch (2,300,000 reads): the
# shape K1 takes on the mesh path
MESH_SHARD_ROWS = -(-ECOLI["genome_len"] * ECOLI["coverage"] // ECOLI["read_len"]
                    // MESH_SHARDS)
MULTIHOST_DATASET = dict(genome_len=200_000, read_len=100, coverage=20.0, seed=3, k=31, m=7,
                         cutoff=1, max_read_len=128)
MULTIHOST_TIMEOUT = 300
# the second multi-device phase (mesh2_e2e): the two-level count of the
# mesh_e2e batch over (2, 2) and (2, 2, 2), each held to the flat count of
# as many shards; the flat 4-shard count's peak on that batch as mesh_e2e
# measured it on an H100 (45.36 GB) and the card's 80 GB, for the peak
# reckoned before the run
MESH2_SHAPES = ((2, 2), (2, 2, 2))
FLAT_MESH_PEAK_BYTES = 45.36e9
CARD_BYTES = 80e9
RECORD_BYTES = 28  # int32 m-mer + int64 key, read id and stream
# the checkpointed count's processes: 7 batches of 3072 x 128 (301,056 slots
# each) of a 200 kb genome at 10x, K=31, M=7; rows divide by 2 and by 3
CKPT_DATASET = dict(genome_len=200_000, read_len=100, coverage=10.0, seed=3, k=31, m=7,
                    cutoff=1, max_read_len=128, rows=3072)
CKPT_TIMEOUT = 300
# bench-scaling's batch on the card (its default of 4096 reads times launches)
BENCH_SCALING_READS = 1 << 20


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

def random_batch(rng, batch, max_len, device):
    """codes [batch, max_len] uint8 and lengths [batch] int32 on `device`;
    lengths from [0, max_len], so empty reads and reads shorter than k
    occur; the tail beyond a read's length is zero, as batch_reads pads it."""
    codes = rng.integers(0, 4, size=(batch, max_len), dtype=np.uint8)
    lengths = rng.integers(0, max_len + 1, size=(batch,)).astype(np.int32)
    codes[np.arange(max_len)[None, :] >= lengths[:, None]] = 0
    return (torch.from_numpy(codes).to(device),
            torch.from_numpy(lengths).to(device))


def coverage_reads(genome_len, read_len, coverage, seed, error_rate=0.0):
    """Uniform-coverage reads, half of them reverse-complemented, with a
    share ``error_rate`` of their bases substituted by another base, made
    with vectorised numpy (the gather in slices of a million reads).
    Returns (genome, reads)."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.zeros(256, dtype=np.uint8)
    comp[letters] = np.frombuffer(b"TGCA", dtype=np.uint8)
    genome = letters[rng.integers(0, 4, size=genome_len)]
    n_reads = int(genome_len * coverage / read_len)
    starts = rng.integers(0, genome_len - read_len + 1, size=n_reads)
    chars = np.empty((n_reads, read_len), dtype=np.uint8)
    for lo in range(0, n_reads, 1 << 20):
        hi = min(n_reads, lo + (1 << 20))
        chars[lo:hi] = genome[starts[lo:hi, None] + np.arange(read_len)[None, :]]
    flip = rng.random(n_reads) < 0.5
    chars[flip] = comp[chars[flip]][:, ::-1]
    if error_rate:
        code = np.zeros(256, dtype=np.int64)
        code[letters] = np.arange(4)
        flat = chars.reshape(-1)
        pos = rng.integers(0, flat.size, size=rng.binomial(flat.size, error_rate))
        flat[pos] = letters[(code[flat[pos]] + rng.integers(1, 4, size=pos.size)) % 4]
    flat = chars.tobytes().decode()
    reads = [flat[i * read_len:(i + 1) * read_len] for i in range(n_reads)]
    return genome.tobytes().decode(), reads


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_env():
    smi = nvidia_smi_line()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=smi)
    return smi


SCAN_KERNELS = ("fast_scan_kernel",)
SORT_KERNELS = ("sort_rows_kernel", "chunk_sort_kernel", "big_ce_kernel", "finish_kernel")
MERGE_KERNELS = ("local_merge_kernel", "merge_pass_kernel", "merge_splits_kernel")
GATHER_KERNELS = ("lane_gather_kernel",)
# redesigned for registers: a spill would undo the design
NO_SPILL_KERNELS = ("fast_scan_kernel", "finish_kernel")


def ptxas_report(log: str, kernels) -> dict:
    """{kernel: registers, static shared bytes, spill bytes} from what
    ``nvcc -Xptxas -v`` printed; an instance of a template kernel is named
    ``kernel<V>``."""
    report, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = next((k for k in kernels if k in m.group(1)), None)
            if current:
                rest = m.group(1).split(current, 1)[1]
                instance = re.search(r"^ILi(\d+)E", rest)
                if instance:
                    current += f"<{instance.group(1)}>"
                elif rest.startswith("I"):  # the mangled template arguments
                    current += f"<{rest[1:rest.index('E')]}>"
                report[current] = {"static_shared_bytes": 0}
        elif current and "spill stores" in line:
            stores, loads = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line).groups()
            report[current].update(spill_store_bytes=int(stores), spill_load_bytes=int(loads))
        elif current and "Used" in line and "registers" in line:
            report[current]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            if smem:
                report[current]["static_shared_bytes"] = int(smem.group(1))
    return report


def phase_build():
    t0 = time.perf_counter()
    # the parity replay engine (g++) builds while nvcc builds the kernels
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        engine = pool.submit(native_build.build)
        libs = csrc_build.build_all(verbose=True)
        engine_lib = engine.result()
    replay_native._load()
    minimizer_cuda._library()
    lib = bitonic_cuda._library()
    mergepath_cuda._library()
    lane_gather_cuda._load()
    if sorted(libs) != ["bitonic", "fast_scan", "lane_gather", "mergepath"]:
        raise AssertionError(f"expected four CUDA sources, built {sorted(libs)}")
    # build_log holds what nvcc printed whether it built now or an earlier
    # run did (the log is kept beside each library)
    report = ptxas_report(csrc_build.build_log.get("fast_scan", ""), SCAN_KERNELS)
    report.update(ptxas_report(csrc_build.build_log.get("bitonic", ""), SORT_KERNELS))
    report.update(ptxas_report(csrc_build.build_log.get("mergepath", ""), MERGE_KERNELS))
    report.update(ptxas_report(csrc_build.build_log.get("lane_gather", ""), GATHER_KERNELS))
    every = SCAN_KERNELS + SORT_KERNELS + MERGE_KERNELS + GATHER_KERNELS
    if sorted({name.split("<")[0] for name in report}) != sorted(every):
        raise AssertionError(f"ptxas reported {sorted(report)}, expected {every}")
    # what ptxas does not see is the DYNAMIC shared memory: 4.25 bytes a base
    # of a warp's read in the scan (its 2-bit words and int32 m-mer scores);
    # 8.5 bytes a key of the chunk in finish (the skewed layout; none where
    # one thread holds the chunk), of the block in the merge sorts and of
    # the chunk or tile in mergepath.cu
    spills = {name: r for name, r in report.items()
              if r.get("spill_store_bytes") or r.get("spill_load_bytes")}
    # the wrapper's block shape and the launcher's shared memory agree
    for log_chunk in range(1, bitonic_cuda.MAX_SHARED_KEYS.bit_length()):
        chunk = 1 << log_chunk
        _, per_thread, _, shared_bytes = bitonic_cuda.finish_shape(chunk)
        if lib.finish_shared_launch_bytes(chunk, per_thread) != shared_bytes:
            raise AssertionError(f"finish_shape({chunk}) and finish_launch disagree on shared memory")
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=dict(csrc_build.build_seconds),
         libraries=sorted(str(p.name) for p in libs.values()),
         operator_libraries=sorted(stem for stem in libs if csrc_build.operator_source(
             csrc_build.CSRC_DIR / f"{stem}.cu") is not None),
         ptxas=report,
         replay_engine=engine_lib.name,
         kernels_with_spills=sorted(spills),
         scan_dynamic_shared_bytes_per_base=4.25, finish_dynamic_shared_bytes_per_key=8.5,
         merge_dynamic_shared_bytes_per_key=8.5,
         finish_shape_at_max_chunk=bitonic_cuda.finish_shape(bitonic_cuda.MAX_SHARED_KEYS),
         max_shared_keys=bitonic_cuda.MAX_SHARED_KEYS,
         max_merge_chunk_keys=mergepath_cuda.MAX_CHUNK_KEYS,
         max_merge_tile_keys=mergepath_cuda.MAX_TILE_KEYS,
         lane_gather_max_staged_cols={"int32": lane_gather_cuda.max_staged_cols(4),
                                      "int64": lane_gather_cuda.max_staged_cols(8)})
    if any(name.split("<")[0] in NO_SPILL_KERNELS for name in spills):
        raise AssertionError(f"spills in {sorted(spills)}")


def compare_scan(codes, lengths, k, m):
    """(mismatching elements, max |kernel - plain|) over mmer, kmer, valid.
    The kernel takes the whole batch in one launch; the plain version runs
    on slices of PLAIN_ROWS rows (each row's windows depend on that row
    alone), which bounds its intermediates."""
    got = minimizer.fast_scan(codes, lengths, k=k, m=m)
    parts = [minimizer.fast_scan_plain(codes[r:r + PLAIN_ROWS], lengths[r:r + PLAIN_ROWS],
                                       k=k, m=m)
             for r in range(0, max(codes.shape[0], 1), PLAIN_ROWS)]
    want = minimizer.WindowRecords(*(torch.cat(lane) for lane in zip(*parts)))
    del parts
    torch.cuda.synchronize()
    mismatches, max_err = 0, 0.0
    for name in ("mmer", "kmer", "valid"):
        g, w = getattr(got, name), getattr(want, name)
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
        if not torch.equal(g, w):
            diff = g != w
            mismatches += int(diff.sum())
            max_err = max(max_err, float((g[diff].double() - w[diff].double()).abs().max()))
    return mismatches, max_err


def scan_batch(rng, batch, max_len, device, kind, offset=0):
    """A batch of a kind: "random" (random_batch), "acgt" (every read ACGT
    repeated to full length: a window of even k that starts at an even base
    equals its reverse complement), "empty" (every length 0).  With an
    offset the codes start that many bytes into their buffer: a row then
    lies at no multiple of 4 bytes."""
    codes, lengths = random_batch(rng, batch, max_len, device)
    if kind == "acgt":
        codes = torch.arange(max_len, device=device).remainder(4).to(torch.uint8).expand(
            batch, max_len).contiguous()
        lengths = torch.full_like(lengths, max_len)
    elif kind == "empty":
        codes = torch.zeros_like(codes)
        lengths = torch.zeros_like(lengths)
    if offset:
        buf = torch.empty(batch * max_len + offset, dtype=torch.uint8, device=device)
        codes = buf[offset:].view(batch, max_len).copy_(codes)
    return codes, lengths


def phase_kernel_check(device):
    rng = np.random.default_rng(1234)
    cases = [(KERNEL_SHAPE[0], KERNEL_SHAPE[1], 31, 7, "random", 0),
             (CHR1_BATCH, 128, 31, 7, "random", 0),  # a chr1 batch's shape
             (MESH_SHARD_ROWS, 128, 31, 7, "random", 0)]  # a mesh shard's rows
    for k, m in [(31, 7), (21, 7), (17, 5), (16, 5), (15, 5), (31, 4)]:
        cases.append((1000, 128, k, m, "random", 0))
        cases.append((1000, 100, k, m, "random", 0))
    cases += [(1, 128, 31, 7, "random", 0), (3, 31, 31, 7, "random", 0),
              (257, 1000, 31, 15, "random", 0)]
    cases += [
        (3, 8192, 31, 7, "random", 0), (2, 8192, 21, 15, "random", 1),  # the longest rows
        (64, 31, 31, 7, "random", 0), (64, 7, 7, 3, "random", 0),  # L == k
        (1000, 129, 31, 7, "random", 0), (1000, 130, 31, 7, "random", 0),  # L % 4 == 1, 2, 3
        (1000, 131, 31, 7, "random", 0), (999, 127, 21, 5, "random", 0),
        (1000, 128, 31, 7, "random", 1), (1000, 131, 31, 7, "random", 3),  # rows off 4 bytes
        (1000, 128, 31, 1, "random", 0), (1000, 64, 5, 1, "random", 0),  # m == 1
        (1000, 128, 15, 15, "random", 0), (1000, 100, 7, 7, "random", 0),  # k == m
        (1000, 128, 1, 1, "random", 0),
        (100, 128, 16, 5, "acgt", 0), (100, 128, 20, 7, "acgt", 0),  # k-mer == its rc
        (100, 130, 30, 15, "acgt", 2),
        (500, 128, 31, 7, "empty", 0), (5, 8192, 31, 7, "empty", 0),
        # the super-k-mer expansion's rows: [n, S_CAP + k - 1], lengths <= L
        (EXPAND_ROWS, 55, 31, 7, "random", 0), (4097, 55, 31, 7, "random", 0),
        (1, 55, 31, 7, "random", 0), (777, 55, 31, 15, "random", 0),
        (3001, 45, 21, 7, "random", 0), (1000, 55, 31, 7, "random", 1),
    ]
    report, total, worst = [], 0, 0.0
    for batch, max_len, k, m, kind, offset in cases:
        codes, lengths = scan_batch(rng, batch, max_len, device, kind, offset)
        mism, err = compare_scan(codes, lengths, k, m)
        report.append({"B": batch, "L": max_len, "k": k, "m": m, "reads": kind,
                       "byte_offset": offset, "mismatches": mism})
        total += mism
        worst = max(worst, err)
    # real rows: the records of an ecoli batch made on the card (an
    # expansion chunk), and two chr1 batches (what scale_chr1 scans)
    chr1 = scale_dataset(device, "chr1")
    for what, (codes, lengths) in (("super-k-mer records", expansion_rows(device, EXPAND_ROWS)),
                                   ("chr1 batch 0", chr1.codes(0)),
                                   (f"chr1 batch {chr1.n_batches - 1}",
                                    chr1.codes(chr1.n_batches - 1))):
        mism, err = compare_scan(codes, lengths, ECOLI["k"], ECOLI["m"])
        report.append({"B": int(codes.shape[0]), "L": int(codes.shape[1]), "k": ECOLI["k"],
                       "m": ECOLI["m"], "reads": what, "byte_offset": 0, "mismatches": mism})
        total += mism
        worst = max(worst, err)
    del chr1
    # what the wrapper must refuse
    codes, lengths = random_batch(rng, 8, 64, device)
    refused = 0
    for bad in (
        lambda: minimizer_cuda.fast_scan_cuda(codes.cpu(), lengths, k=21, m=7),
        lambda: minimizer_cuda.fast_scan_cuda(codes.int(), lengths, k=21, m=7),
        lambda: minimizer_cuda.fast_scan_cuda(codes.t(), lengths, k=21, m=7),
        lambda: minimizer_cuda.fast_scan_cuda(codes[:, ::2], lengths, k=21, m=7),
        lambda: minimizer_cuda.fast_scan_cuda(codes, lengths[:4], k=21, m=7),
        lambda: minimizer_cuda.fast_scan_cuda(
            torch.zeros((2, 9000), dtype=torch.uint8, device=device),
            lengths[:2], k=21, m=7),
    ):
        try:
            bad()
        except (ValueError, TypeError):
            refused += 1
    gather = check_lane_gather(rng, device)
    emit("kernel_check", tolerance=0, mismatches=total, max_abs_err=worst,
         refused_bad_inputs=refused, cases=report, lane_gather=gather)
    if total or refused != 6:
        raise AssertionError(f"kernel_check failed: {total} mismatches, {refused}/6 refusals")
    if (gather["mismatches"] or gather["refused_bad_inputs"] != len(LANE_GATHER_REFUSALS)
            or gather["refusals_launched"]):
        raise AssertionError(f"kernel_check failed for K5: {gather}")
    return (total, worst), (gather["mismatches"], gather["max_abs_err"])


# K5's shapes: the probe's two blocks, the size it is timed at, rows past the
# widest staged row (direct loads), ragged widths; every pattern of indices
LANE_GATHER_SHAPES = [((256, 128), torch.int32), ((256, 1024), torch.int32),
                      ((65536, 1024), torch.int32), ((65536, 1024), torch.int64),
                      ((1000, 37), torch.int32), ((3, 1), torch.int64),
                      ((7, 12288), torch.int32), ((7, 12289), torch.int32),
                      ((9, 6144), torch.int64), ((9, 6145), torch.int64),
                      ((64, 20000), torch.int64), ((16, 100000), torch.int32)]
LANE_GATHER_PATTERNS = ("random", "zero", "last", "identity")
# what the wrapper and the dispatcher must refuse (x, idx) on the card
LANE_GATHER_REFUSALS = ("cpu", "int32 values int64 indices", "int64 values int32 indices",
                        "float values", "non-contiguous", "shapes differ", "one axis",
                        "index -1", "index == cols")


def lane_gather_input(gen, shape, dtype, pattern, device):
    rows, cols = shape
    info = torch.iinfo(dtype)
    x = torch.randint(info.min, info.max, shape, dtype=dtype, device=device, generator=gen)
    if pattern == "random":
        idx = torch.randint(0, cols, shape, dtype=dtype, device=device, generator=gen)
    elif pattern == "zero":
        idx = torch.zeros(shape, dtype=dtype, device=device)
    elif pattern == "last":
        idx = torch.full(shape, cols - 1, dtype=dtype, device=device)
    else:
        idx = torch.arange(cols, dtype=dtype, device=device).expand(rows, cols).contiguous()
    return x, idx


def check_lane_gather(rng, device):
    """K5 bit-exact against its plain version and torch.gather at every
    LANE_GATHER_SHAPES x LANE_GATHER_PATTERNS, through the dispatcher; an
    index outside its row gives 0 from the bare wrapper; the refusals."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(1 << 31)))
    cases, total, worst = [], 0, 0.0
    for shape, dtype in LANE_GATHER_SHAPES:
        for pattern in LANE_GATHER_PATTERNS:
            x, idx = lane_gather_input(gen, shape, dtype, pattern, device)
            got = lane_gather.lane_gather(x, idx)
            mism = 0
            for want in (lane_gather.lane_gather_plain(x, idx), torch.gather(x, 1, idx.long())):
                diff = got != want
                n = int(diff.sum())
                if n:
                    worst = max(worst, float((got[diff].double() - want[diff].double()).abs().max()))
                mism += n
            total += mism
            cases.append({"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                          "indices": pattern, "mismatches": mism})
    x, idx = lane_gather_input(gen, (4, 100), torch.int64, "random", device)
    idx[1, 7], idx[2, 9] = -1, 100
    out = lane_gather_cuda.lane_gather_cuda(x, idx)
    plain = lane_gather.lane_gather_plain(x, idx.clamp(0, 99))
    inside = torch.ones_like(idx, dtype=torch.bool)
    inside[1, 7] = inside[2, 9] = False
    outside_zero = bool((out[~inside] == 0).all()) and bool(torch.equal(out[inside], plain[inside]))
    x32, i32 = lane_gather_input(gen, (8, 64), torch.int32, "random", device)
    bad_calls = {
        "cpu": lambda: lane_gather_cuda.lane_gather_cuda(x32.cpu(), i32.cpu()),
        "int32 values int64 indices": lambda: lane_gather.lane_gather(x32, i32.long()),
        "int64 values int32 indices": lambda: lane_gather.lane_gather(x32.long(), i32),
        "float values": lambda: lane_gather.lane_gather(x32.float(), i32),
        "non-contiguous": lambda: lane_gather_cuda.lane_gather_cuda(x32[:, ::2], i32[:, ::2]),
        "shapes differ": lambda: lane_gather.lane_gather(x32, i32[:4]),
        "one axis": lambda: lane_gather.lane_gather(x32.reshape(-1), i32.reshape(-1)),
        "index -1": lambda: lane_gather.lane_gather(x32, i32 - i32.max() - 1),
        "index == cols": lambda: lane_gather.lane_gather(x32, torch.full_like(i32, 64)),
    }
    refused = []
    launched = lane_gather_cuda.launch_count()
    for name in LANE_GATHER_REFUSALS:
        try:
            bad_calls[name]()
        except (ValueError, TypeError):
            refused.append(name)
    refusals_launched = lane_gather_cuda.launch_count() - launched
    torch.cuda.synchronize()
    return {"tolerance": 0, "mismatches": total + (0 if outside_zero else 1),
            "max_abs_err": worst, "outside_index_gives_0": outside_zero,
            "refused_bad_inputs": len(refused), "refused": refused,
            "refusals_launched": refusals_launched, "cases": cases}


def random_keys(gen, n, device, sentinel_share=0.0):
    """n int64 keys below 2^62, drawn on the card; a share of them SENTINEL."""
    key = torch.randint(0, 1 << 62, (n,), dtype=torch.int64, device=device, generator=gen)
    if sentinel_share:
        pad = torch.rand((n,), device=device, generator=gen) < sentinel_share
        key = torch.where(pad, SENTINEL, key)
    return key


def key_patterns(gen, n, device):
    """The inputs every pass is held on: random keys with duplicates and
    sentinels at the front, all-equal keys, sorted and reverse sorted."""
    key = random_keys(gen, n, device)
    key[::5] = key[0].clone()
    key[::11] = key[1 % n].clone()
    key[:3] = SENTINEL
    ordered = torch.sort(key).values
    return {"random": key, "all_equal": torch.full_like(key, 12345),
            "sorted": ordered, "reversed": ordered.flip(0)}


class Tally:
    """Counts comparisons and the elements that differ (tolerance 0)."""

    def __init__(self):
        self.cases = 0
        self.mismatches = 0
        self.max_abs_err = 0.0

    def hold(self, got, want):
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{got.shape} {got.dtype} vs {want.shape} {want.dtype}")
        self.cases += 1
        if not torch.equal(got, want):
            diff = got != want
            self.mismatches += int(diff.sum())
            err = (got[diff].double() - want[diff].double()).abs().max()
            self.max_abs_err = max(self.max_abs_err, float(err))

    def report(self):
        return {"cases": self.cases, "mismatches": self.mismatches,
                "max_abs_err": self.max_abs_err}


def levels_up_to(size):
    return [1 << b for b in range(1, size.bit_length())]


@contextlib.contextmanager
def merge_sort_block(block_keys):
    """Inside, the two merge sorts take at least `block_keys` keys a thread
    block."""
    before = bitonic_cuda.BLOCK_KEYS
    bitonic_cuda.BLOCK_KEYS = block_keys
    try:
        yield
    finally:
        bitonic_cuda.BLOCK_KEYS = before


def sort_patterns(gen, n, device):
    """key_patterns and keys that are all the padding key."""
    patterns = key_patterns(gen, n, device)
    patterns["all_sentinel"] = torch.full_like(patterns["random"], SENTINEL)
    return patterns


def check_sort_rows(gen, device):
    """K2 against its plain version and the library's row sort: every row
    length 2 .. 2^14 (rows shorter than the keys a thread among them) with 1,
    3, 5 and 1000 rows, so that rows * C is a multiple of no block; blocks of
    one row, of the default and of 2^14 keys; every input pattern at C = 64 and
    2^14; more blocks than the grid."""
    t = Tally()
    widths = [1 << b for b in range(1, bitonic_cuda.MAX_SHARED_KEYS.bit_length())]
    for rows in (1, 3, 5, 1000):
        for c in widths:
            key = key_patterns(gen, rows * c, device)["random"].view(rows, c)
            got = bitonic_sort.sort_rows(key)
            t.hold(got, bitonic_sort.sort_rows_plain(key))
            t.hold(got, torch.sort(key, dim=1).values)
    for block_keys in (2, bitonic_cuda.MAX_SHARED_KEYS):  # one row a block; the largest block
        with merge_sort_block(block_keys):
            for rows, c in ((37, 64), (5, 1024), (3, bitonic_cuda.MAX_SHARED_KEYS)):
                key = key_patterns(gen, rows * c, device)["random"].view(rows, c)
                t.hold(bitonic_sort.sort_rows(key), torch.sort(key, dim=1).values)
    for rows, c in ((5000, 64), (5, bitonic_cuda.MAX_SHARED_KEYS)):
        for name, key in sort_patterns(gen, rows * c, device).items():
            key = key.view(rows, c)
            t.hold(bitonic_sort.sort_rows(key), bitonic_sort.sort_rows_plain(key))
    key = random_keys(gen, 1 << 24, device, 0.3).view(-1, 64)  # more blocks than the grid has
    t.hold(bitonic_sort.sort_rows(key), torch.sort(key, dim=1).values)
    return t


def check_chunk_sort(gen, device):
    """K3a against chunk_sort_plain, every call counted: a list 2, 4 .. s must
    launch the merge sort once and nothing else.  Chunks 2 .. 2^14, an odd
    number of chunks, every input pattern; at chunk 2^14 every prefix 2 .. s
    (descending runs at every level); blocks of one run, of the default and of
    2^14 keys; in place; more blocks of keys than the grid has blocks."""
    t = Tally()

    def hold(key, sizes, chunk):
        before = dict(bitonic_cuda.launch_count)
        got = bitonic_sort.chunk_sort(key, sizes, chunk=chunk)
        ran = {name: count - before[name] for name, count in bitonic_cuda.launch_count.items()
               if count != before[name]}
        if ran != {"chunk_sort": 1}:
            raise AssertionError(f"chunk_sort({sizes}, chunk={chunk}) launched {ran}")
        t.hold(got, bitonic_sort.chunk_sort_plain(key, sizes, chunk=chunk))

    largest = bitonic_cuda.MAX_SHARED_KEYS
    for chunk in (2, 64, 4096, 8192, largest):
        for name, key in sort_patterns(gen, chunk * 23, device).items():
            hold(key, levels_up_to(chunk), chunk)
    for top in levels_up_to(largest):
        for name, key in sort_patterns(gen, largest * 5, device).items():
            hold(key, levels_up_to(top), largest)
    for block_keys in (2, largest):
        with merge_sort_block(block_keys):
            for top in (2, 8, 64, 1024, largest):
                hold(key_patterns(gen, largest * 3, device)["random"], levels_up_to(top), largest)
    hold(random_keys(gen, 1 << 24, device, 0.3), levels_up_to(64), 64)  # more blocks than the grid
    key = key_patterns(gen, largest * 7, device)["random"]
    sizes = levels_up_to(largest)
    want = bitonic_sort.chunk_sort_plain(key, sizes, chunk=largest)
    got = bitonic_sort.chunk_sort(key, sizes, chunk=largest, overwrite=True)
    if got.data_ptr() != key.data_ptr():
        raise AssertionError("chunk_sort(overwrite=True) did not work in place")
    t.hold(got, want)
    return t


def bitonic_chunks(key, chunk):
    """Every chunk of `key` bitonic: its first half ascending, its second
    half descending (what finish meets in a sort)."""
    halves = torch.sort(key.view(-1, chunk // 2), dim=1).values
    halves[1::2] = halves[1::2].flip(1)
    return halves.view(-1)


@contextlib.contextmanager
def finish_keys_per_thread(per_thread):
    """Inside, finish takes `per_thread` keys a thread."""
    before = bitonic_cuda.FINISH_KEYS_PER_THREAD
    bitonic_cuda.FINISH_KEYS_PER_THREAD = per_thread
    try:
        yield
    finally:
        bitonic_cuda.FINISH_KEYS_PER_THREAD = before


def check_finish(gen, device):
    """K3c against finish_plain, every call counted: every chunk 2 .. 2^14 (an
    odd number of chunks), the level at the chunk (the direction alternates
    chunk by chunk) and above it, up to and past the array; random keys (no
    bitonic runs: the kernel is the same compare-exchanges, so it equals the
    plain version on any input), bitonic chunks, all-equal and all-pad keys;
    16 and 32 keys a thread; more chunks than the grid has blocks; in place."""
    t = Tally()

    def hold(key, size, chunk, overwrite=False):
        want = bitonic_sort.finish_plain(key, size, chunk=chunk)
        launched = bitonic_cuda.launch_count["finish"]
        got = bitonic_sort.finish(key, size, chunk=chunk, overwrite=overwrite)
        if bitonic_cuda.launch_count["finish"] != launched + 1:
            raise AssertionError(f"finish(size={size}, chunk={chunk}) did not launch once")
        if overwrite and got.data_ptr() != key.data_ptr():
            raise AssertionError("finish(overwrite=True) did not work in place")
        t.hold(got, want)

    largest = bitonic_cuda.MAX_SHARED_KEYS
    for per_thread in (16, 32):
        with finish_keys_per_thread(per_thread):
            for chunk in levels_up_to(largest):
                n = chunk * 23
                patterns = sort_patterns(gen, n, device)
                patterns["bitonic"] = bitonic_chunks(patterns["random"], chunk)
                for name, key in patterns.items():
                    for size in (chunk, 2 * chunk, 32 * chunk, 1 << 40):
                        hold(key, size, chunk)
    hold(random_keys(gen, 64 * 5000, device, 0.3), 64, 64)  # more chunks than the grid
    hold(random_keys(gen, 1 << 24, device, 0.3), 1 << 24, largest)
    for chunk in (2, 64, largest):
        hold(key_patterns(gen, chunk * 7, device)["random"], 2 * chunk, chunk, overwrite=True)
        # keys at 8 bytes past a multiple of 16: the stores go one key at a time
        hold(key_patterns(gen, chunk * 7 + 1, device)["random"][1:], 2 * chunk, chunk,
             overwrite=True)
    return t


def check_big_ce(gen, device):
    t = Tally()
    n, chunk = 1 << 20, bitonic_cuda.MAX_SHARED_KEYS
    stages = [(n // 2, n), (chunk, n), (chunk, 2 * chunk), (1, 2), (1, n), (32, 1 << 40)]
    for name, key in key_patterns(gen, n, device).items():
        for d, size in stages:  # the largest and the smallest d of a level, and the edges
            t.hold(bitonic_sort.big_ce(key, d, size), bitonic_sort.big_ce_plain(key, d, size))
    key = key_patterns(gen, 3 << 15, device)["random"]  # not a power of two
    want = bitonic_sort.big_ce_plain(key, chunk, 2 * chunk)
    before = key.clone()
    t.hold(bitonic_sort.big_ce(key, chunk, 2 * chunk), want)
    t.hold(key, before)  # without overwrite the caller's tensor is untouched
    got = bitonic_sort.big_ce(key, chunk, 2 * chunk, overwrite=True)
    if got.data_ptr() != key.data_ptr():
        raise AssertionError("big_ce(overwrite=True) did not work in place")
    t.hold(got, want)
    return t


def check_wide_index(gen, device):
    """Positions past 2^31: in-place big_ce, finish and chunk_sort (the merge
    sort: the direction of a run comes from its global position) on 2^31 +
    2^22 keys (17 GB), the last 2^22 keys held against the plain version.  The
    slice starts at 2^31, a multiple of twice the level, so positions within
    it have the level's bit where the global positions have it."""
    t = Tally()
    n, tail, size, chunk = (1 << 31) + (1 << 22), 1 << 22, 1 << 21, bitonic_cuda.MAX_SHARED_KEYS
    key = random_keys(gen, n, device)
    head_before, tail_before = key[:tail].clone(), key[n - tail:].clone()
    key = bitonic_sort.big_ce(key, size // 2, size, overwrite=True)
    t.hold(key[:tail], bitonic_sort.big_ce_plain(head_before, size // 2, size))
    t.hold(key[n - tail:], bitonic_sort.big_ce_plain(tail_before, size // 2, size))
    head_before, tail_before = key[:tail].clone(), key[n - tail:].clone()
    key = bitonic_sort.finish(key, size, chunk=chunk, overwrite=True)
    t.hold(key[:tail], bitonic_sort.finish_plain(head_before, size, chunk=chunk))
    t.hold(key[n - tail:], bitonic_sort.finish_plain(tail_before, size, chunk=chunk))
    head_before, tail_before = key[:tail].clone(), key[n - tail:].clone()
    sizes = levels_up_to(chunk)
    launched = bitonic_cuda.launch_count["chunk_sort"]
    key = bitonic_sort.chunk_sort(key, sizes, chunk=chunk, overwrite=True)
    if bitonic_cuda.launch_count["chunk_sort"] != launched + 1:
        raise AssertionError("the wide chunk_sort did not go through the merge sort")
    t.hold(key[:tail], bitonic_sort.chunk_sort_plain(head_before, sizes, chunk=chunk))
    t.hold(key[n - tail:], bitonic_sort.chunk_sort_plain(tail_before, sizes, chunk=chunk))
    return t


def check_composed_sorts(gen, device):
    """sort_keys and sort_keys_hybrid against torch.sort: a power-of-two n, an
    n that needs padding, and n at and just above each fallback threshold,
    with small chunks and with the defaults.  The launch counts show that
    the network ran exactly where it should."""
    t = {"sort_keys": Tally(), "sort_keys_hybrid": Tally()}
    chunk, lib = bitonic_sort.DEFAULT_CHUNK, bitonic_sort.DEFAULT_LIB_CHUNK
    plans = [
        ("sort_keys", dict(chunk=64), [(1 << 16, True), (50000, True), (127, False), (128, True)]),
        ("sort_keys", {}, [(2 * chunk - 1, False), (2 * chunk, True), (100000, True)]),
        ("sort_keys_hybrid", dict(lib_chunk=1024, chunk=64),
         [(1 << 16, True), (50000, True), (2048, False), (2049, True)]),
        ("sort_keys_hybrid", {}, [(2 * lib, False), (2 * lib + 1, True), (4 * lib, True)]),
    ]
    for name, kwargs, sizes in plans:
        for n, network in sizes:
            key = key_patterns(gen, n, device)["random"]
            before = key.clone()
            launched = bitonic_cuda.launch_count["finish"]
            got = getattr(bitonic_sort, name)(key, **kwargs)
            if (bitonic_cuda.launch_count["finish"] > launched) != network:
                raise AssertionError(f"{name}({n}, {kwargs}): network ran != {network}")
            t[name].hold(got, torch.sort(key).values)
            t[name].hold(key, before)
    return t


def count_refusals(device):
    """Every wrapper must refuse what its kernel does not take."""
    k64 = torch.zeros(64, dtype=torch.int64, device=device)
    rows = k64.view(8, 8)
    too_many = 2 * bitonic_cuda.MAX_SHARED_KEYS
    big = torch.zeros(2 * too_many, dtype=torch.int64, device=device)
    bad = [
        lambda: bitonic_cuda.sort_rows_cuda(rows.cpu()),
        lambda: bitonic_cuda.sort_rows_cuda(rows.int()),
        lambda: bitonic_cuda.sort_rows_cuda(rows.t()),
        lambda: bitonic_cuda.sort_rows_cuda(k64.view(4, 16)[:, :12]),
        lambda: bitonic_cuda.sort_rows_cuda(k64[:48].view(8, 6)),
        lambda: bitonic_cuda.sort_rows_cuda(big.view(2, too_many)),
        lambda: bitonic_cuda.sort_rows_cuda(k64),
        lambda: bitonic_cuda.chunk_sort_cuda(k64.cpu(), [2, 4], chunk=4),
        lambda: bitonic_cuda.chunk_sort_cuda(k64.int(), [2, 4], chunk=4),
        lambda: bitonic_cuda.chunk_sort_cuda(big[::2], [2, 4], chunk=4),
        lambda: bitonic_cuda.chunk_sort_cuda(k64[:48], [2, 4], chunk=12),
        lambda: bitonic_cuda.chunk_sort_cuda(k64, [2, 4], chunk=128),
        lambda: bitonic_cuda.chunk_sort_cuda(big, [2, 4], chunk=too_many),
        lambda: bitonic_cuda.chunk_sort_cuda(k64, [4, 2], chunk=4),
        lambda: bitonic_cuda.chunk_sort_cuda(k64, [3], chunk=4),
        # a list that is no complete prefix 2, 4 .. s <= chunk: a partial network
        lambda: bitonic_cuda.chunk_sort_cuda(k64, [], chunk=8),
        lambda: bitonic_cuda.chunk_sort_cuda(k64, [16], chunk=8),
        lambda: bitonic_cuda.chunk_sort_cuda(k64, [2, 8], chunk=8),
        lambda: bitonic_cuda.chunk_sort_cuda(k64, [2, 4, 8, 16], chunk=8),
        lambda: bitonic_cuda.chunk_sort_cuda(k64, [2, 8, 1 << 40], chunk=8),
        lambda: bitonic_cuda.big_ce_cuda(k64.cpu(), 8, 16),
        lambda: bitonic_cuda.big_ce_cuda(k64.int(), 8, 16),
        lambda: bitonic_cuda.big_ce_cuda(big[::2][:64], 8, 16),
        lambda: bitonic_cuda.big_ce_cuda(k64, 6, 16),
        lambda: bitonic_cuda.big_ce_cuda(k64, 8, 8),
        lambda: bitonic_cuda.big_ce_cuda(k64, 64, 128),
        lambda: bitonic_cuda.finish_cuda(k64.cpu(), 16, chunk=8),
        lambda: bitonic_cuda.finish_cuda(k64.int(), 16, chunk=8),
        lambda: bitonic_cuda.finish_cuda(big[::2][:64], 16, chunk=8),
        lambda: bitonic_cuda.finish_cuda(k64[:48], 24, chunk=12),
        lambda: bitonic_cuda.finish_cuda(k64, 4, chunk=8),
        lambda: bitonic_cuda.finish_cuda(big, 2 * too_many, chunk=too_many),
        lambda: bitonic_sort.sort_keys_hybrid(k64, lib_chunk=8, chunk=16),
        lambda: bitonic_sort.sort_keys(k64, chunk=12),
    ]
    # what the launchers of the two merge sorts refuse themselves (they return
    # an error and launch nothing): a block shorter than a run or than one
    # thread's keys, no power of two, larger than shared memory; keys that are
    # no whole number of runs; a run that is no power of two; no rows
    lib = bitonic_cuda._library()
    spare = torch.empty_like(k64)
    src, dst = k64.data_ptr(), spare.data_ptr()

    def launcher(call):
        def refused():
            if call() != 0:
                raise ValueError("the launcher returned an error")
        return refused

    for block_keys in (4, 8, 48, 2 * too_many):
        bad.append(launcher(lambda b=block_keys: lib.sort_rows_launch(src, dst, 8, 8, b, None)))
        bad.append(launcher(lambda b=block_keys: lib.chunk_sort_launch(src, dst, 64, 8, b, None)))
    bad += [launcher(lambda: lib.chunk_sort_launch(src, dst, 64, 32, 16, None)),
            launcher(lambda: lib.chunk_sort_launch(src, dst, 60, 8, 64, None)),
            launcher(lambda: lib.chunk_sort_launch(src, dst, 64, 6, 64, None)),
            launcher(lambda: lib.sort_rows_launch(src, dst, 0, 8, 64, None))]
    return refused_of(bad, bitonic_cuda.launch_count), len(bad)


def refused_of(bad, launch_count):
    """How many of the calls raise ValueError or TypeError; none may launch."""
    launches = dict(launch_count)
    refused = 0
    for call in bad:
        try:
            call()
        except (ValueError, TypeError):
            refused += 1
    if launch_count != launches:
        raise AssertionError("a refused call launched a kernel")
    return refused


def phase_sort_check(device):
    gen = torch.Generator(device=device)
    gen.manual_seed(4321)
    tallies = {
        "sort_rows": check_sort_rows(gen, device),
        "chunk_sort": check_chunk_sort(gen, device),
        "big_ce": check_big_ce(gen, device),
        "finish": check_finish(gen, device),
    }
    tallies.update(check_composed_sorts(gen, device))
    tallies["wide_index"] = check_wide_index(gen, device)
    torch.cuda.synchronize()
    refused, n_bad = count_refusals(device)
    report = {name: t.report() for name, t in tallies.items()}
    emit("sort_check", tolerance=0, refused_bad_inputs=refused, bad_inputs=n_bad, **report)
    total = sum(t.mismatches for t in tallies.values())
    if total or refused != n_bad:
        raise AssertionError(
            f"sort_check failed: {total} mismatches, {refused}/{n_bad} refusals")
    torch.cuda.empty_cache()
    return tallies


# --------------------------------------------------------------------------
# the merge-path passes (csrc/mergepath.cu)
# --------------------------------------------------------------------------

def sorted_runs(key, run):
    """The flat keys, ascending within every run of `run` keys."""
    return torch.sort(key.view(-1, run), dim=1).values.reshape(-1)


def merge_inputs(gen, n, run, device):
    """Valid inputs of one merge level (runs of `run` ascending): random keys
    with duplicates; all-equal; every key about 50 times (ties across every
    split, as the main path's coverage gives them); sorted (every B wholly
    above its A) and the same with the runs of every pair swapped (A above
    B), the two ends of the split search; a run pair of SENTINEL only; a
    SENTINEL tail as padding leaves it; and pairs in which one run is used up
    inside a tile while the other still holds keys EQUAL to SENTINEL (A all
    real keys and B real keys then SENTINELs, and the reverse): a merge that
    told a used-up run by its key's value would go wrong there."""
    patterns = key_patterns(gen, n, device)
    fifty = torch.randint(0, max(n // 50, 1), (n,), dtype=torch.int64, device=device,
                          generator=gen)
    ordered = patterns["sorted"]
    no_pair = patterns["random"].clone()
    no_pair[: 2 * run] = SENTINEL
    tail = ordered.clone()
    tail[n - n // 3:] = SENTINEL
    swapped = ordered.view(-1, 2, run).flip(1).reshape(-1)
    a_runs_out = random_keys(gen, n, device).view(-1, 2, run)
    a_runs_out[:, 1, min(run // 2 + 3, run - 1):] = SENTINEL
    states = {"random": patterns["random"], "all_equal": patterns["all_equal"],
              "fifty_fold": fifty, "b_above_a": ordered, "a_above_b": swapped,
              "sentinel_pair": no_pair, "padded_tail": tail,
              "a_runs_out_b_holds_sentinels": a_runs_out.reshape(-1),
              "b_runs_out_a_holds_sentinels": a_runs_out.flip(1).reshape(-1)}
    return {name: sorted_runs(key, run) for name, key in states.items()}


def check_local_merge(gen, device, chunks=(2, 4, 16, 64, 4096, 8192,
                                           mergepath_cuda.MAX_CHUNK_KEYS)):
    """K4a against its plain version and against the library sort of every
    chunk, on valid input only (runs of base_run ascending: the kernel merges
    with two heads, which is the network only there): chunk 2 .. the largest,
    base_run 1, 2, 8, 16, 32 .. chunk / 2, a chunk count that is no power of
    two, 8, 16 and 32 keys a thread, levels that stop below the chunk, more
    chunks than the grid has blocks, and in place."""
    t = Tally()
    before = mergepath_cuda.LOCAL_KEYS_PER_THREAD
    try:
        for chunk in chunks:
            n = chunk * 24
            bases = sorted(b for b in {1, 2, 8, 16, 32, 1024, chunk // 32, chunk // 2}
                           if 1 <= b <= chunk // 2)
            for per_thread in (16, 32, 8):
                mergepath_cuda.LOCAL_KEYS_PER_THREAD = per_thread
                for name, key in key_patterns(gen, n, device).items():
                    for base_run in bases:
                        levels = merge_levels(base_run, chunk)
                        state = sorted_runs(key, base_run)
                        got = mergepath_sort.local_merge(state, levels, chunk=chunk)
                        t.hold(got, mergepath_sort.local_merge_plain(state, levels, chunk=chunk))
                        t.hold(got, sorted_runs(key, chunk))
                        if len(levels) > 1 and name == "random":  # stop one level early
                            t.hold(mergepath_sort.local_merge(state, levels[:-1], chunk=chunk),
                                   sorted_runs(key, chunk // 2))
    finally:
        mergepath_cuda.LOCAL_KEYS_PER_THREAD = before
    key = key_patterns(gen, 2 * 5000, device)["random"]  # more chunks than blocks
    want = mergepath_sort.local_merge_plain(key, [2], chunk=2)
    before = key.clone()
    t.hold(mergepath_sort.local_merge(key, [2], chunk=2), want)
    t.hold(key, before)  # without overwrite the caller's tensor is untouched
    got = mergepath_sort.local_merge(key, [2], chunk=2, overwrite=True)
    if got.data_ptr() != key.data_ptr():
        raise AssertionError("local_merge(overwrite=True) did not work in place")
    t.hold(got, want)
    return t


def hold_merge_pass(t, splits_tally, state, run, tile):
    """One level held against its plain versions: merge_splits_kernel against
    merge_splits_plain (bit for bit, on any input), the segments the K4b
    kernel derives (they must fill the tile), and K4b against merge_pass_plain
    and against the library sort of every run pair."""
    splits = mergepath_sort.merge_splits(state, run, tile)
    for ours, theirs in zip(splits, mergepath_sort.merge_splits_plain(state, run, tile)):
        splits_tally.hold(ours, theirs)
    a1, b1 = mergepath_sort.tile_segments(splits, run, tile)
    if not bool(((a1 - splits[0]) + (b1 - splits[1]) == tile).all()):
        raise AssertionError(f"run {run} tile {tile}: a tile's segments do not sum to the tile")
    got = mergepath_sort.merge_pass(state, splits, run=run, tile=tile)
    t.hold(got, mergepath_sort.merge_pass_plain(state, splits, run=run, tile=tile))
    t.hold(got, sorted_runs(state, 2 * run))


def check_merge_pass(gen, device, max_tile=mergepath_cuda.MAX_TILE_KEYS):
    """K4b and merge_splits_kernel: tile 2 .. the largest, run = tile .. 64
    tiles, three run pairs (no power of two), every input of merge_inputs, 4,
    8 and 16 keys a thread (2, for a tile of 2 keys, is in the shapes).  The
    split kernel is also held on keys whose runs do NOT ascend: its search
    has one answer on any input."""
    t, st = Tally(), Tally()
    before = mergepath_cuda.KEYS_PER_THREAD
    shapes = [(2, 2), (2, 64), (4, 4), (8, 32), (64, 64), (64, 4096),
              (max_tile // 2, max_tile // 2), (max_tile // 2, 4 * max_tile),
              (max_tile, max_tile), (max_tile, 16 * max_tile), (max_tile // 2, 32 * max_tile)]
    for tile, run in shapes:
        for name, state in merge_inputs(gen, 6 * run, run, device).items():
            hold_merge_pass(t, st, state, run, tile)
        raw = random_keys(gen, 6 * run, device, 0.3)
        for ours, theirs in zip(mergepath_sort.merge_splits(raw, run, tile),
                                mergepath_sort.merge_splits_plain(raw, run, tile)):
            st.hold(ours, theirs)
    try:
        for per_thread in (4, 8, 16):
            mergepath_cuda.KEYS_PER_THREAD = per_thread
            for tile in (16, max_tile // 8, max_tile):
                for name, state in merge_inputs(gen, 8 * tile, 2 * tile, device).items():
                    hold_merge_pass(t, st, state, 2 * tile, tile)
    finally:
        mergepath_cuda.KEYS_PER_THREAD = before
    return t, st


def check_merge_wide_index(device, run=1 << 26, pairs=17, tile=None):
    """Positions past 2^31: one merge_splits_kernel launch (held against
    merge_splits_plain) and one K4b pass over 2^31 + 2^27 keys (two buffers of
    18.3 GB).  The runs are made arithmetically (run r holds offset_r +
    stride_r * i: ascending, with ties between the runs of a pair), since
    sorting them there would not fit; the first and the LAST run pair are held
    against the library sort of that pair (the plain version does not fit
    either), every pair must come out ascending, and the sum of all keys
    must be kept."""
    tile = mergepath_sort.DEFAULT_MERGE_TILE if tile is None else tile
    t, st = Tally(), Tally()
    n = 2 * pairs * run
    key = torch.empty(n, dtype=torch.int64, device=device)
    step = torch.arange(run, dtype=torch.int64, device=device)
    for r in range(2 * pairs):
        torch.add(step * (3 + r * 7 % 5), r * 12345 % 1000, out=key[r * run:(r + 1) * run])
    del step
    splits = mergepath_sort.merge_splits(key, run, tile)
    for ours, theirs in zip(splits, mergepath_sort.merge_splits_plain(key, run, tile)):
        st.hold(ours, theirs)
    got = mergepath_sort.merge_pass(key, splits, run=run, tile=tile)
    del splits
    for pair in (0, pairs - 1):
        span = slice(pair * 2 * run, (pair + 1) * 2 * run)
        t.hold(got[span], torch.sort(key[span]).values)
    ascending = all(bool((got[p * 2 * run + 1:(p + 1) * 2 * run]
                          >= got[p * 2 * run:(p + 1) * 2 * run - 1]).all()) for p in range(pairs))
    if not ascending or int(got.sum()) != int(key.sum()):
        raise AssertionError("merge_pass past position 2^31: a pair is not ascending, "
                             "or keys were lost")
    return t, st, n


def check_composed_mergepath(gen, device):
    """sort_keys_mergepath against torch.sort: at 4 chunk - 1 (library), 4 chunk
    and 4 chunk + 1, at an n that is no power of two, with small constants and
    with the defaults, with base_run 1 (no library sort), 2^10 (library row
    sorts first) and == chunk (no K4a launch).  The launch counts show that
    the kernels ran exactly where they should."""
    t = Tally()
    chunk = mergepath_sort.DEFAULT_MERGE_CHUNK
    plans = [
        (dict(tile=16, base_run=8, chunk=64), [255, 256, 257, 50000, 1 << 16]),
        (dict(tile=2, base_run=1, chunk=2), [7, 8, 1000]),
        (dict(tile=64, base_run=64, chunk=64), [256, 50000]),
        ({}, [4 * chunk - 1, 4 * chunk, 4 * chunk + 1, 300000]),
        (dict(base_run=1), [4 * chunk, 300000]),
        (dict(base_run=1 << 10), [4 * chunk, 300000]),
        (dict(base_run=chunk), [4 * chunk, 300000]),
    ]
    for kwargs, sizes in plans:
        c = kwargs.get("chunk", chunk)
        for n in sizes:
            key = key_patterns(gen, n, device)["random"]
            before = key.clone()
            launched = dict(mergepath_cuda.launch_count)
            got = mergepath_sort.sort_keys_mergepath(key, **kwargs)
            ran = tuple(mergepath_cuda.launch_count[name] - launched[name]
                        for name in ("local_merge", "merge_pass", "merge_splits"))
            base_run = kwargs.get("base_run", mergepath_sort.DEFAULT_BASE_RUN)
            want = mergepath_pass_counts(n, base_run, c)
            if ran != want:
                raise AssertionError(
                    f"sort_keys_mergepath({n}, {kwargs}) launched local_merge, merge_pass, "
                    f"merge_splits {ran}; the sizes give {want}")
            t.hold(got, torch.sort(key).values)
            t.hold(key, before)
    return t


def merge_refusals(device):
    """Every merge-path wrapper must refuse what its kernel does not take."""
    k64 = torch.zeros(64, dtype=torch.int64, device=device)
    s8 = torch.zeros(8, dtype=torch.int64, device=device)
    big_chunk = 2 * mergepath_cuda.MAX_CHUNK_KEYS
    big_tile = 2 * mergepath_cuda.MAX_TILE_KEYS
    big = torch.zeros(2 * big_chunk, dtype=torch.int64, device=device)
    s_big = torch.zeros(big.shape[0] // big_tile, dtype=torch.int64, device=device)
    lm, mp = mergepath_cuda.local_merge_cuda, mergepath_cuda.merge_pass_cuda
    sp = mergepath_cuda.merge_splits_cuda
    bad = [
        lambda: lm(k64, [2, 8], chunk=8),     # gapped levels: not one run of merges
        lambda: lm(k64, [4, 16], chunk=16),
        lambda: lm(k64, [], chunk=8),
        lambda: sp(k64.cpu(), 8, 8),
        lambda: sp(k64.int(), 8, 8),
        lambda: sp(big[::2][:64], 8, 8),
        lambda: sp(k64, 8, 16),
        lambda: sp(k64, 12, 4),
        lambda: sp(k64[:48], 16, 8),
        lambda: sp(k64.view(8, 8), 8, 8),
        lambda: lm(k64.cpu(), [4, 8], chunk=8),
        lambda: lm(k64.int(), [4, 8], chunk=8),
        lambda: lm(big[::2][:64], [4, 8], chunk=8),
        lambda: lm(k64[:48], [4], chunk=12),
        lambda: lm(k64, [4], chunk=128),
        lambda: lm(k64, [8, 4], chunk=8),
        lambda: lm(k64, [16], chunk=8),
        lambda: lm(k64, [3], chunk=8),
        lambda: lm(big, [4], chunk=big_chunk),
        lambda: mp(k64.cpu(), s8, s8, run=8, tile=8),
        lambda: mp(k64.int(), s8, s8, run=8, tile=8),
        lambda: mp(big[::2][:64], s8, s8, run=8, tile=8),
        lambda: mp(k64, s8, s8, run=8, tile=16),
        lambda: mp(k64, s8, s8, run=12, tile=4),
        lambda: mp(k64[:48], s8[:6], s8[:6], run=16, tile=8),
        lambda: mp(k64, s8.cpu(), s8, run=8, tile=8),
        lambda: mp(k64, s8, s8.int(), run=8, tile=8),
        lambda: mp(k64, s8[:4], s8, run=8, tile=8),
        lambda: mp(k64, s8, s8, run=8, tile=8, out=k64),
        lambda: mp(big[:64], s8, s8, run=8, tile=8, out=big[8:72]),
        lambda: mp(k64, s8, s8, run=8, tile=8, out=k64.cpu()),
        lambda: mp(k64, s8, s8, run=8, tile=8, out=big[:64].int()),
        lambda: mp(big, s_big, s_big, run=big_tile, tile=big_tile),
        lambda: mergepath_sort.sort_keys_mergepath(k64, tile=32, base_run=4, chunk=16),
        lambda: mergepath_sort.sort_keys_mergepath(k64, tile=8, base_run=4, chunk=24),
        lambda: mergepath_sort.sort_keys_mergepath(k64, tile=8, base_run=32, chunk=16),
        lambda: mergepath_sort.sort_keys_mergepath(k64.view(8, 8), tile=8, base_run=4, chunk=16),
    ]
    return refused_of(bad, mergepath_cuda.launch_count), len(bad)


def phase_merge_check(device):
    gen = torch.Generator(device=device)
    gen.manual_seed(8765)
    tallies = {"local_merge": check_local_merge(gen, device)}
    tallies["merge_pass"], tallies["merge_splits"] = check_merge_pass(gen, device)
    tallies["sort_keys_mergepath"] = check_composed_mergepath(gen, device)
    torch.cuda.empty_cache()
    (tallies["merge_wide_index"], tallies["merge_splits_wide_index"],
     wide_keys) = check_merge_wide_index(device)
    torch.cuda.synchronize()
    refused, n_bad = merge_refusals(device)
    report = {name: t.report() for name, t in tallies.items()}
    emit("merge_check", tolerance=0, refused_bad_inputs=refused, bad_inputs=n_bad,
         wide_index_keys=wide_keys, **report)
    total = sum(t.mismatches for t in tallies.values())
    if total or refused != n_bad:
        raise AssertionError(
            f"merge_check failed: {total} mismatches, {refused}/{n_bad} refusals")
    torch.cuda.empty_cache()
    return tallies


def scanned_keys(reads, cfg, device):
    """The canonical k-mer key of every window slot of a read set (SENTINEL
    where a read has no window), batch by batch through the scan: what the
    count phase sorts (the last batch padded to a full one, as the pipeline
    pads it)."""
    batches = reads_io.batch_reads(reads, cfg.max_read_len, cfg.batch_reads)
    if len(batches) > 1:
        batches[-1] = reads_io.pad_batch(batches[-1], cfg.batch_reads)
    keys = []
    for codes, lengths, _ in stream_io.feed_read_batches(batches, device):
        keys.append(minimizer.fast_scan(codes, lengths, k=cfg.k, m=cfg.m).kmer.reshape(-1))
    return torch.cat(keys)


def kept_table(reads, cfg, device):
    """Sorted kept canonical keys of a read set, by the ops alone."""
    key = scanned_keys(reads, cfg, device)
    recs = minimizer.WindowRecords(mmer=key[:0].int(), kmer=key, valid=key != SENTINEL)
    kc = count_ops.count_keys(recs, cutoff=cfg.abundance_cutoff)
    kmer, valid = count_ops.kept_keys_sorted(kc)
    return kmer[: int(valid.sum())].cpu().numpy()


def check_exactly_once(unitigs, kept, k):
    """Every kept canonical k-mer lies in exactly one unitig, once."""
    _, rows = dbg.unitig_member_nodes(kept, unitigs, k)
    if rows.size != kept.size or not np.array_equal(np.sort(rows), np.arange(kept.size)):
        raise AssertionError(
            f"coverage is not exactly-once: {rows.size} unitig k-mers, "
            f"{np.unique(rows).size} distinct, {kept.size} kept")


def counters(stats):
    return {f: getattr(stats, f) for f in (
        "n_reads", "n_windows", "entries_pre_prune", "entries_post_prune",
        "entries_post_extension")}


def phase_small_e2e(device):
    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=3000, read_len=64, coverage=8, seed=5, with_reverse=True)
    cfg = PipelineConfig(k=21, m=7, parity=False, max_read_len=128, batch_reads=16384)
    on_card, s_card = FastAssembler(cfg, device=device).unitigs(reads)
    on_cpu, s_cpu = FastAssembler(cfg, device="cpu").unitigs(reads)
    same = on_card == on_cpu and counters(s_card) == counters(s_cpu)
    check_exactly_once(on_card, kept_table(reads, cfg, device), cfg.k)
    emit("small_e2e", equal_cuda_cpu=same, n_unitigs=len(on_card), **counters(s_card))
    if not same or not on_card:
        raise AssertionError("small_e2e: card and CPU runs differ")


def reset_launch_counts():
    minimizer_cuda.launch_count = 0
    lane_gather_cuda.reset_launch_count()
    for counts in (bitonic_cuda.launch_count, mergepath_cuda.launch_count):
        for name in counts:
            counts[name] = 0


def read_launch_counts():
    return {"fast_scan": minimizer_cuda.launch_count, **bitonic_cuda.launch_count,
            **mergepath_cuda.launch_count, "lane_gather": lane_gather_cuda.launch_count()}


def hybrid_pass_counts(n, lib_chunk, chunk):
    """(big_ce launches, finish launches) of sort_keys_hybrid on n keys, from
    the sizes alone: the array pads to lib_chunk * 2^j; each level above
    lib_chunk has one big stage per distance from size/2 down to chunk, and
    one finish."""
    if n <= 2 * lib_chunk:
        return 0, 0
    total = lib_chunk
    while total < n:
        total *= 2
    levels = range(lib_chunk.bit_length(), total.bit_length())  # log2 of each level
    log_chunk = chunk.bit_length() - 1
    return sum(level - log_chunk for level in levels), len(levels)


def ecoli_config(hybrid_sort=False):
    return PipelineConfig(k=ECOLI["k"], m=ECOLI["m"], parity=False,
                          abundance_cutoff=ECOLI["cutoff"], batch_reads=ECOLI["batch_reads"],
                          max_read_len=ECOLI["max_read_len"], hybrid_sort=hybrid_sort)


class NoClock:
    """A phase clock that neither times nor synchronises."""

    def start(self, name):
        pass

    def stop(self):
        pass


def synchronising_calls(fn):
    """(result of fn(), the synchronising CUDA calls torch reported while it
    ran under set_sync_debug_mode("warn"), where in Python they came from)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    calls = [w for w in caught if "synchroniz" in str(w.message)]
    return out, len(calls), sorted({f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in calls})


def scan_read_backs(device, reads, n_batches):
    """The synchronising CUDA calls of FastAssembler's scan phase over
    `n_batches` batches of `reads` (the last one ragged, padded as the
    pipeline pads it): ``_flat_fast_records`` with a phase clock that does not
    synchronise.  Returns (calls, where from, windows counted, valid windows
    in the records)."""
    cfg = ecoli_config()
    subset = reads[: (n_batches - 1) * cfg.batch_reads + cfg.batch_reads // 3]
    asm = FastAssembler(cfg, device=device)
    stats = PhaseStats()
    (recs, _), calls, where = synchronising_calls(
        lambda: asm._flat_fast_records(subset, stats, NoClock()))
    return calls, where, stats.n_windows, int(recs.valid.sum())


def run_ecoli(device, reads, *, hybrid_sort):
    """One FastAssembler.unitigs call on the ecoli read set, with the launch
    counts set to 0 just before it and read just after."""
    cfg = ecoli_config(hybrid_sort)
    asm = FastAssembler(cfg, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    unitigs, stats = asm.unitigs(reads)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_batches = -(-len(reads) // cfg.batch_reads)
    if launches["fast_scan"] != n_batches:
        raise AssertionError(f"{launches['fast_scan']} scan launches for {n_batches} batches")
    slots = n_batches * cfg.batch_reads * cfg.windows_per_read
    fields = dict(
        hybrid_sort=hybrid_sort, k=cfg.k, m=cfg.m, batch_reads=cfg.batch_reads,
        max_read_len=cfg.max_read_len, n_batches=n_batches, window_slots=slots,
        key_bytes=slots * 8, launches=launches, phase_seconds=dict(stats.wall_s),
        assemble_wall_seconds=wall,
        kmers_counted_per_s=stats.n_windows / (stats.wall_s["scan"] + stats.wall_s["count"]),
        extension_states_per_s=2 * stats.entries_post_prune
        / (stats.wall_s["links"] + stats.wall_s["jump"]),
        max_memory_allocated=peak, n_unitigs=len(unitigs), **counters(stats))
    return cfg, unitigs, stats, launches, fields


def phase_full_e2e(device, coverage):
    p = dict(ECOLI, coverage=coverage)
    t0 = time.perf_counter()
    genome, reads = coverage_reads(p["genome_len"], p["read_len"], p["coverage"], seed=0)
    t_reads = time.perf_counter() - t0
    cfg, unitigs, stats, launches, fields = run_ecoli(device, reads, hybrid_sort=False)
    if any(launches[name] for name in (*bitonic_cuda.launch_count, *mergepath_cuda.launch_count)):
        raise AssertionError(f"the default path launched a sort kernel: {launches}")
    t0 = time.perf_counter()
    kept = kept_table(reads, cfg, device)
    if kept.size != stats.entries_post_prune:
        raise AssertionError("kept table size differs from entries_post_prune")
    check_exactly_once(unitigs, kept, cfg.k)
    longest = max(unitigs, key=len)
    if longest not in genome and dbg._rc_str(longest) not in genome:
        raise AssertionError("longest unitig is not a substring of the genome")
    t_check = time.perf_counter() - t0
    # the scan phase reads back once, after its last batch, however many
    # batches it has: one synchronising call over 2 batches and over 5.  The
    # first measurement in a process is reported, not held: it also counts
    # what torch synchronises once on its first use under the debug mode
    read_backs = {}
    for label, n_batches in (("first, 1", 1), (2, 2), (5, 5)):
        calls, where, counted, valid = scan_read_backs(device, reads, n_batches)
        read_backs[label] = {"synchronising_calls": calls, "from": where}
        if counted != valid or (n_batches > 1 and calls != 1):
            raise AssertionError(f"scan phase over {n_batches} batches: {calls} synchronising "
                                 f"calls ({where}), {counted} windows counted of {valid}")
    emit("full_e2e", preset="ecoli", genome_len=p["genome_len"], coverage=p["coverage"],
         coverage_cut=p["coverage"] != ECOLI["coverage"], read_len=p["read_len"],
         read_generation_host_seconds=t_reads, longest_unitig=len(longest),
         exactly_once=True, longest_in_genome=True, check_seconds=t_check,
         scan_synchronising_calls_by_batches=read_backs,
         **fields)
    # the first batch of this run is what the scan kernel is timed on
    first = reads_io.batch_reads(reads[: cfg.batch_reads], cfg.max_read_len, cfg.batch_reads)[0]
    return dict(reads=reads, kept=kept, unitigs=unitigs, counters=counters(stats),
                launches=launches, first_batch=first, fields=fields)


# --------------------------------------------------------------------------
# surfaces_e2e: the CLI's --trace/--metrics, count checkpoints, the feeder,
# the parity out-of-core checkpoints and the entry step
# --------------------------------------------------------------------------

FAST_PHASES = ("batch", "scan", "count", "links", "jump", "materialize")
# the fields of the JAX package's fast-mode `assemble` record, in its order
ASSEMBLE_FIELDS = ["ts", "run", "event", "wall_s", "mode", "k", "m", "entries_post_prune",
                   "n_unitigs", "n_windows"]
COUNT_FIELDS = ["ts", "run", "event", "wall_s", "k", "m", "n_reads", "n_windows",
                "entries_pre_prune", "entries_post_prune"]
DEVICE_EVENT_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
# the batch the entry step is also held on: overlapping reads, most k-mers kept
ENTRY_COVERAGE = dict(genome_len=20_000, read_len=128, coverage=16, seed=1, with_reverse=True)


def interval_union(spans):
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def busy_share(spans, lo, hi):
    """The share of [lo, hi] that the union of the spans covers."""
    return interval_union([(max(a, lo), min(b, hi)) for a, b in spans if b > lo and a < hi]) / (
        hi - lo)


def read_trace(trace_dir):
    """(device events by kind as (name, start, end) in us, host ranges
    (name, start, end), file bytes) of the one Chrome trace in trace_dir."""
    (path,) = pathlib.Path(trace_dir).glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    device = {kind: [] for kind in DEVICE_EVENT_KINDS}
    ranges = []
    for e in events:
        if e.get("ph") != "X":
            continue
        span = (e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
        if e.get("cat") in device:
            device[e["cat"]].append(span)
        elif e.get("cat") == "user_annotation":
            ranges.append(span)
    return device, ranges, path.stat().st_size


def trace_report(device_events, ranges):
    """The device busy share of the `assemble` range (kernels; kernels and
    copies), the same within each phase range, and the five device
    operations that took the most time."""
    kernels = [(a, b) for _, a, b in device_events["kernel"]]
    every = [(a, b) for kind in DEVICE_EVENT_KINDS for _, a, b in device_events[kind]]
    seen = {}
    for name, _, _ in ranges:
        seen[name] = seen.get(name, 0) + 1
    want = ["assemble", *FAST_PHASES]
    if any(seen.get(name) != 1 for name in want):
        raise AssertionError(f"surfaces_e2e: trace ranges {seen}, want one each of {want}")
    window = {name: (a, b) for name, a, b in ranges if name in want}
    lo, hi = window["assemble"]
    phases = {}
    for name in FAST_PHASES:
        a, b = window[name]
        phases[name] = dict(wall_ms=(b - a) / 1e3, kernel_busy_share=busy_share(kernels, a, b),
                            device_busy_share=busy_share(every, a, b))
    totals = {}
    for kind in DEVICE_EVENT_KINDS:
        for name, a, b in device_events[kind]:
            t = totals.setdefault(name, [0.0, 0, kind])
            t[0] += b - a
            t[1] += 1
    top = sorted(totals.items(), key=lambda kv: -kv[1][0])[:5]
    return dict(
        assemble_wall_ms=(hi - lo) / 1e3,
        kernel_busy_share=busy_share(kernels, lo, hi),
        device_busy_share=busy_share(every, lo, hi),
        kernel_busy_ms=interval_union([(max(a, lo), min(b, hi)) for a, b in kernels
                                       if b > lo and a < hi]) / 1e3,
        by_phase=phases, other_ranges={n: c for n, c in seen.items() if n not in want},
        top5_device_ops=[dict(name=name[:120], kind=kind, ms=us / 1e3, events=n)
                         for name, (us, n, kind) in top],
        device_events={kind: len(v) for kind, v in device_events.items()})


def jsonl_record(path, fields):
    """The one JSONL record in path, held to the JAX package's field order."""
    (line,) = pathlib.Path(path).read_text().splitlines()
    rec = json.loads(line)
    if list(rec) != fields:
        raise AssertionError(f"surfaces_e2e: metrics record keys {list(rec)} != {fields}")
    return rec


def surfaces_traced_assemble(device, full, tmp):
    """`assemble --mode fast --trace --metrics` through cli.main on the card,
    on full_e2e's reads and config: its lines == full_e2e's unitigs, K1
    launched once a batch, the trace holds K1 and one range a phase."""
    reads, fields = full["reads"], full["fields"]
    reads_path = tmp / "ecoli_reads.txt"
    t0 = time.perf_counter()
    reads_path.write_text("\n".join(reads) + "\n")
    t_write = time.perf_counter() - t0
    out_path, jsonl, trace_dir = tmp / "unitigs.txt", tmp / "assemble.jsonl", tmp / "trace"
    args = ["assemble", str(reads_path), "--mode", "fast", "--k", str(ECOLI["k"]),
            "--m", str(ECOLI["m"]), "--cutoff", str(ECOLI["cutoff"]),
            "--batch-reads", str(ECOLI["batch_reads"]),
            "--max-read-len", str(ECOLI["max_read_len"]),
            "--trace", str(trace_dir), "--metrics", str(jsonl)]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with open(out_path, "w") as out, contextlib.redirect_stdout(out):
        rc = cli.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launch_counts()
    lines = out_path.read_text().splitlines()
    rec = jsonl_record(jsonl, ASSEMBLE_FIELDS)
    want = full["counters"]
    same = dict(
        exit_code_0=rc == 0, lines_equal_full_e2e=lines == full["unitigs"],
        k1_launches_equal_batches=launches["fast_scan"] == fields["n_batches"],
        no_sort_kernel=not any(v for n, v in launches.items() if n != "fast_scan"),
        metrics_equal=(rec["event"], rec["mode"], rec["k"], rec["m"], rec["entries_post_prune"],
                       rec["n_unitigs"], rec["n_windows"])
        == ("assemble", "fast", ECOLI["k"], ECOLI["m"], want["entries_post_prune"],
            len(full["unitigs"]), want["n_windows"]))
    t0 = time.perf_counter()
    device_events, ranges, trace_bytes = read_trace(trace_dir)
    report = trace_report(device_events, ranges)
    t_read = time.perf_counter() - t0
    k1_events = sum("fast_scan_kernel" in name for name, _, _ in device_events["kernel"])
    same["k1_events_equal_launches"] = k1_events == launches["fast_scan"]
    emit("surfaces_trace", nvidia_smi=nvidia_smi_line(), **report)
    return dict(args=args[2:], wall_seconds=wall, full_e2e_wall_seconds=fields["assemble_wall_seconds"],
                metrics_wall_s=rec["wall_s"], reads_write_seconds=t_write,
                trace_bytes=trace_bytes, trace_read_seconds=t_read, k1_trace_events=k1_events,
                launches=launches, checks=same)


def surfaces_count_checkpoint(device, parity_runs, tmp):
    """`count --checkpoint --metrics` in parity mode on BASELINE.md's big run
    through cli.main on the card; the file loads back equal, lane for lane,
    to CountPipeline.count_reads of the same read ids on the card."""
    p = PARITY_E2E
    _, lines, _ = datagen.generate_coverage_reads(
        genome_len=p["genome_len"], read_len=p["read_len"], coverage=p["coverage"],
        seed=p["seed"])
    reads_path, ckpt, jsonl = tmp / "big_run.txt", tmp / "big_run_count.npz", tmp / "count.jsonl"
    datagen.write_reads(lines, str(reads_path))
    reset_launch_counts()
    t0 = time.perf_counter()
    with timed_calls(checkpoint_io, "save_counted_table") as saves:
        rc = cli.main(["count", str(reads_path), "--k", str(p["k"]), "--m", str(p["m"]),
                       "--cutoff", str(p["cutoff"]), "--batch-reads", str(p["batch_reads"]),
                       "--max-read-len", str(p["max_read_len"]),
                       "--checkpoint", str(ckpt), "--metrics", str(jsonl)])
    wall = time.perf_counter() - t0
    no_kernel_launched("surfaces_e2e count")
    rec = jsonl_record(jsonl, COUNT_FIELDS)
    (table, cfg, phase), t_load, _ = timed_call(lambda: checkpoint_io.load_counted_table(ckpt))
    want_cfg = parity_config(p)
    counted, stats = CountPipeline(want_cfg, device=device).count_reads(parity_runs["ids"])
    got_lanes = convert.counted_table_to_lanes(table)
    want_lanes = convert.counted_table_to_lanes(counted)
    same = dict(
        exit_code_0=rc == 0, one_save=len(saves) == 1, phase=phase == "post-count",
        config=cfg == want_cfg,
        lanes=all(a.dtype == b.dtype and np.array_equal(a, b)
                  for a, b in zip(got_lanes, want_lanes)),
        metrics=[rec[f] for f in COUNT_FIELDS[4:]]
        == [p["k"], p["m"], stats.n_reads, stats.n_windows, stats.entries_pre_prune,
            stats.entries_post_prune])
    return dict(cli_wall_seconds=wall, count_wall_s=rec["wall_s"], save_seconds=saves,
                load_seconds=t_load,
                file_bytes=ckpt.stat().st_size, rows=int(got_lanes[0].shape[0]),
                entries_pre_prune=stats.entries_pre_prune,
                entries_post_prune=stats.entries_post_prune, checks=same)


def live_threads():
    return {t for t in threading.enumerate() if t is not threading.current_thread()}


def surfaces_feeder(device, reads):
    """The ecoli batches through feed_read_batches == the plain copies,
    tensor for tensor; a consumer that breaks off after 3 batches (in a
    `with` block, and one that only drops the feeder) leaves no worker alive
    and its staged batches freed."""
    cfg = ecoli_config()
    batches = reads_io.batch_reads(reads, cfg.max_read_len, cfg.batch_reads)
    batches[-1] = reads_io.pad_batch(batches[-1], cfg.batch_reads)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    equal = 0
    with stream_io.feed_read_batches(batches, device) as feeder:
        for b, staged in zip(batches, feeder):
            plain = [t.to(device) for t in convert.read_batch_to_torch(b)]
            equal += all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(staged, plain))
    torch.cuda.synchronize()
    t_feed = time.perf_counter() - t0
    broken_off = {}
    for form in ("with", "dropped"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before_threads, before_bytes = live_threads(), torch.cuda.memory_allocated()
        if form == "with":
            with stream_io.feed_read_batches(batches, device) as feeder:
                for i, _ in enumerate(feeder):
                    if i == 2:
                        break
        else:
            for i, _ in enumerate(stream_io.feed_read_batches(batches, device)):
                if i == 2:
                    break
        del _
        feeder = None
        workers = live_threads() - before_threads
        for t in workers:
            t.join(timeout=10.0)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        broken_off[form] = dict(
            workers_alive=sum(t.is_alive() for t in workers),
            memory_allocated_before=before_bytes,
            memory_allocated_after=torch.cuda.memory_allocated())
    same = dict(batches_equal=equal == len(batches),
                **{f"{form}_stopped": v["workers_alive"] == 0
                   and v["memory_allocated_after"] == v["memory_allocated_before"]
                   for form, v in broken_off.items()})
    return dict(batches=len(batches), feed_seconds=t_feed, broken_off_after_3=broken_off,
                checks=same)


def surfaces_parity_ooc_checkpoint(device, tmp):
    """partitioned_count_parity(checkpoint_dir=) on the card at the
    parity_ooc_scale size: a run into a fresh directory, again from the full
    directory, and again after half of its part files were deleted; both
    give the first run's HostTable, array for array."""
    p = PARITY_OOC_SCALE
    _, lines, _ = datagen.generate_coverage_reads(
        genome_len=p["genome_len"], read_len=p["read_len"], coverage=p["coverage"],
        seed=p["seed"])
    ids = fgets_read_ids(lines)
    asm = ParityAssembler(parity_config(p), device=device)
    if not asm._needs_outofcore(ids):
        raise AssertionError("surfaces_e2e: the parity read set stays in core")
    ckdir = tmp / "parity_ooc"
    runs = {}
    deleted = []
    reset_launch_counts()
    for label in ("fresh", "full_directory", "half_deleted"):
        if label == "half_deleted":
            deleted = sorted(ckdir.glob("part_*_parity.npz"))[::2]
            for path in deleted:
                path.unlink()
        (host, stats), seconds, peak = timed_call(
            lambda: asm._groups_outofcore(ids, -1, checkpoint_dir=str(ckdir)))
        runs[label] = dict(host=host, stats=stats, seconds=seconds, peak=peak,
                           parts=len(list(ckdir.glob("part_*_parity.npz"))))
        torch.cuda.empty_cache()
    no_kernel_launched("surfaces_e2e parity checkpoint")
    first = runs["fresh"]
    same = {label: host_tables_equal(first["host"], r["host"])
            and counters(first["stats"]) == counters(r["stats"])
            for label, r in runs.items() if label != "fresh"}
    return dict(read_ids=len(ids), groups=len(first["host"].mmer),
                partitions=runs["fresh"]["parts"],
                directory_bytes=sum(f.stat().st_size for f in ckdir.iterdir()),
                runs={label: dict(seconds=r["seconds"], max_memory_allocated=r["peak"],
                                  parts_on_disk_after=r["parts"])
                      for label, r in runs.items()},
                deleted_parts=len(deleted),
                checks=same)


def surfaces_entry(device):
    """entry()'s step on the card == the same step on the CPU, on the
    entry's own batch and on a batch of overlapping reads."""
    step, args = entry_mod.entry(device)
    cpu_step, cpu_args = entry_mod.entry("cpu")
    _, reads, _ = datagen.generate_coverage_reads(**ENTRY_COVERAGE)
    (batch,) = reads_io.batch_reads(reads, ENTRY_COVERAGE["read_len"])
    cov = (torch.from_numpy(batch.codes), torch.from_numpy(batch.lengths))
    out, checks = {}, {}
    for label, card_args, host_args in (("example", args, cpu_args),
                                        ("coverage", tuple(t.to(device) for t in cov), cov)):
        reset_launch_counts()
        got = step(*card_args)
        torch.cuda.synchronize()
        k1 = read_launch_counts()["fast_scan"]
        want = cpu_step(*host_args)
        checks[label] = k1 == 1 and all(
            g.shape == w.shape and torch.equal(g.cpu(), w) for g, w in zip(got, want))
        out[label] = dict(shape=list(card_args[0].shape), n_kept=int(want[0]),
                          states=int(want[1].shape[0]), k1_launches=k1)
    checks["coverage_keeps_kmers"] = out["coverage"]["n_kept"] > 0
    return dict(batches=out, checks=checks)


def phase_surfaces_e2e(device, full, parity_runs):
    """The one-device surfaces at the main path's size: the traced CLI
    assembly, count checkpoints, the feeder, the parity out-of-core
    checkpoints and the entry step (see the parts' docstrings)."""
    t_start = time.perf_counter()
    parts = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        for name, run in (("traced_assemble", lambda: surfaces_traced_assemble(device, full, tmp)),
                          ("count_checkpoint",
                           lambda: surfaces_count_checkpoint(device, parity_runs, tmp)),
                          ("feeder", lambda: surfaces_feeder(device, full["reads"])),
                          ("parity_ooc_checkpoint",
                           lambda: surfaces_parity_ooc_checkpoint(device, tmp)),
                          ("entry", lambda: surfaces_entry(device))):
            t0 = time.perf_counter()
            parts[name] = dict(run(), seconds=time.perf_counter() - t0)
            torch.cuda.empty_cache()
    failed = {name: part["checks"] for name, part in parts.items()
              if not all(part["checks"].values())}
    emit("surfaces_e2e", seconds=time.perf_counter() - t_start, **parts)
    if failed:
        raise AssertionError(f"surfaces_e2e: checks failed: {failed}")


def phase_hybrid_e2e(device, full):
    """The kernel-sort path at full width: the same reads as full_e2e, with
    ``hybrid_sort=True``.  Held against full_e2e's result, so the default
    path and the kernel path check each other on the card."""
    cfg, unitigs, stats, launches, fields = run_ecoli(device, full["reads"], hybrid_sort=True)
    want_big, want_finish = hybrid_pass_counts(
        fields["window_slots"], bitonic_sort.DEFAULT_LIB_CHUNK, bitonic_sort.DEFAULT_CHUNK)
    if unitigs != full["unitigs"] or counters(stats) != full["counters"]:
        raise AssertionError("hybrid_e2e: unitigs or counters differ from full_e2e's")
    if (launches["big_ce"], launches["finish"]) != (want_big, want_finish):
        raise AssertionError(
            f"hybrid_e2e launched big_ce {launches['big_ce']} and finish "
            f"{launches['finish']} times; the sizes give {want_big} and {want_finish}")
    if not (want_big and want_finish):
        raise AssertionError("the read set is too small to reach the sorting network")
    if any(launches[name] for name in ("sort_rows", "chunk_sort", *mergepath_cuda.launch_count)):
        raise AssertionError(f"hybrid_e2e launched a kernel off its path: {launches}")
    check_exactly_once(unitigs, full["kept"], cfg.k)
    emit("hybrid_e2e", preset="ecoli", same_reads_as="full_e2e",
         equal_to_full_e2e=True, exactly_once=True,
         lib_chunk=bitonic_sort.DEFAULT_LIB_CHUNK, chunk=bitonic_sort.DEFAULT_CHUNK,
         expected_big_ce_launches=want_big, expected_finish_launches=want_finish,
         full_e2e_phase_seconds=full["fields"]["phase_seconds"],
         full_e2e_max_memory_allocated=full["fields"]["max_memory_allocated"],
         full_e2e_kmers_counted_per_s=full["fields"]["kmers_counted_per_s"], **fields)
    return launches


# --------------------------------------------------------------------------
# over a mesh
# --------------------------------------------------------------------------

def card_devices():
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def reset_peaks(devices):
    for d in devices:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)


def peaks(devices):
    return {str(d): torch.cuda.max_memory_allocated(d) for d in devices}


def timed_mesh(devices, fn):
    """fn() with the launch counts and every card's peak set to 0 just
    before it; (result, wall seconds, peak bytes by card, launches)."""
    reset_peaks(devices)
    reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    for d in devices:
        torch.cuda.synchronize(d)
    return out, time.perf_counter() - t0, peaks(devices), read_launch_counts()


def multihost_runs():
    """(processes, backend, --device) of each run_multihost.py launch: NCCL
    with a card a process where there are several cards; NCCL over one
    process and gloo over two processes on card 0 where there is one."""
    count = torch.cuda.device_count()
    if count > 1:
        return [(count, "nccl", "cuda")]
    return [(1, "nccl", "cuda"), (2, "gloo", "cuda:0")]


def run_multihost_launches():
    """Every launch of multihost_runs() at once, each a launcher process
    (it starts and stops its workers); (run, summary) pairs.  A launch
    that fails fails the phase; none is left running."""
    root = pathlib.Path(__file__).resolve().parent
    dataset = [arg for name, value in MULTIHOST_DATASET.items()
               for arg in (f"--{name.replace('_', '-')}", str(value))]
    with tempfile.TemporaryDirectory() as tmp:
        launches = []
        for i, (procs, backend, device) in enumerate(multihost_runs()):
            out = pathlib.Path(tmp) / f"summary{i}.json"
            cmd = [sys.executable, "-m", "genome_assembly_tpu_torch.tools.run_multihost",
                   "--procs", str(procs), "--backend", backend, "--device", device,
                   "--out", str(out), "--timeout", str(MULTIHOST_TIMEOUT), *dataset]
            launches.append(((procs, backend, device), out, subprocess.Popen(
                cmd, cwd=str(root), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        results, failed = [], []
        for run, out, proc in launches:
            try:
                _, err = proc.communicate(timeout=MULTIHOST_TIMEOUT + 60)
            except subprocess.TimeoutExpired:
                proc.kill()
                _, err = proc.communicate()
            if proc.returncode:
                failed.append(f"{run}: exit {proc.returncode}\n{err[-3000:]}")
            else:
                results.append((run, json.loads(out.read_text())))
    if failed:
        raise AssertionError("mesh_e2e: run_multihost failed:\n" + "\n".join(failed))
    return results


def phase_mesh_e2e(device, full, parity_runs):
    """The mesh path (one process, MESH_SHARDS shards: all on the card, or
    one a card where there are several): ``FastAssembler.unitigs(mesh=)``
    on the ecoli reads (key routing, padded blocks) == full_e2e's list and
    counters, K1 once a shard, and K1 == its plain version on each shard's
    rows of that batch; the ragged count of the same reads, its kept
    keys == full_e2e's kept table; ``ParityAssembler.assemble(mesh=)`` on
    the goldens' input (padded and ragged, byte for byte) and on
    BASELINE.md's big run, clean (padded) and dirty (ragged) side by side,
    == parity_e2e's lines; and run_multihost.py's processes == the
    one-process mesh of as many shards.  Every overflow counter 0 (the
    assemblers raise on one)."""
    cards = card_devices()
    devices = cards if len(cards) > 1 else [device]
    mesh = mesh_lib.make_mesh(MESH_SHARDS, devices=devices)
    reads = full["reads"]
    cfg = ecoli_config()
    asm = FastAssembler(cfg, device=device)
    (unitigs, stats), wall, peak, launches = timed_mesh(
        cards, lambda: asm.unitigs(reads, mesh=mesh))
    padded = dict(
        equal_to_full_e2e=unitigs == full["unitigs"],
        counters_equal=counters(stats) == full["counters"], phase_seconds=dict(stats.wall_s),
        assemble_wall_seconds=wall, max_memory_allocated_by_card=peak, launches=launches,
        n_unitigs=len(unitigs), **counters(stats))
    mesh_k1 = launches["fast_scan"]
    if not (padded["equal_to_full_e2e"] and padded["counters_equal"]):
        raise AssertionError(f"mesh_e2e: the mesh's unitigs differ from full_e2e's: {padded}")
    if mesh_k1 != MESH_SHARDS or any(sort_kernel_launches(launches).values()):
        raise AssertionError(f"mesh_e2e: launches {launches}, want K1 once a shard")
    del unitigs
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    (batch,) = reads_io.batch_reads(reads, cfg.max_read_len)
    batch = reads_io.pad_batch(batch, -(-batch.n // MESH_SHARDS) * MESH_SHARDS)
    t_batch = time.perf_counter() - t0

    # K1 against its plain version on each shard's rows of the batch the
    # mesh path scanned (not counted as launches of the path)
    shard_scans = []
    for s, (codes, lengths) in enumerate(zip(mesh.shard_rows(batch.codes),
                                             mesh.shard_rows(batch.lengths))):
        mism, err = compare_scan(codes, lengths, cfg.k, cfg.m)
        shard_scans.append(dict(shard=s, shape=list(codes.shape), mismatches=mism,
                                max_abs_err=err))
        del codes, lengths
    scan_tally = (sum(x["mismatches"] for x in shard_scans),
                  max(x["max_abs_err"] for x in shard_scans))
    if scan_tally[0] or shard_scans[0]["shape"] != [MESH_SHARD_ROWS, cfg.max_read_len]:
        raise AssertionError(f"mesh_e2e: K1 on the shards' rows: {shard_scans}")
    torch.cuda.empty_cache()

    def ragged_kept():
        sc = shard_count.sharded_count(
            batch.codes, batch.lengths, batch.read_ids, k=cfg.k, m=cfg.m, parity=False,
            cutoff=cfg.abundance_cutoff, mesh=mesh, routing="ragged", route_by="key")
        overflow = mesh.total(sc.overflow)
        kept = torch.cat([x[keep].to(device) for x, keep in zip(sc.kmer, sc.keep)])
        return overflow, torch.sort(kept).values.cpu().numpy()

    (overflow, kept), r_wall, r_peak, r_launches = timed_mesh(cards, ragged_kept)
    ragged = dict(overflow=overflow, kept_equal_full_e2e=np.array_equal(kept, full["kept"]),
                  batch_host_seconds=t_batch, count_wall_seconds=r_wall,
                  max_memory_allocated_by_card=r_peak, launches=r_launches)
    if overflow or not ragged["kept_equal_full_e2e"] or r_launches["fast_scan"] != MESH_SHARDS:
        raise AssertionError(f"mesh_e2e: the ragged count differs: {ragged}")
    del kept
    torch.cuda.empty_cache()

    golden_reads = reads_io.load_reads_parity(str(GOLDEN / "input.txt"))
    want = ((GOLDEN / "input_k6m3_unitigs.txt").read_text().splitlines(),
            (GOLDEN / "input_k6m3_verbose.txt").read_text())
    goldens = []
    for routing in ("padded", "ragged"):
        for batch_reads in (64, 7):
            gasm = ParityAssembler(PipelineConfig(k=6, m=3, max_read_len=32,
                                                  batch_reads=batch_reads), device=device)
            got = (gasm.assemble(golden_reads, engine="native", mesh=mesh, routing=routing)[0],
                   gasm.assemble(golden_reads, engine="native", verbose=True, mesh=mesh,
                                 routing=routing)[0])
            goldens.append(dict(routing=routing, batch_reads=batch_reads,
                                unitigs_exact=got[0] == want[0], verbose_exact=got[1] == want[1]))
            if got != want:
                raise AssertionError(f"mesh_e2e: parity goldens over the mesh: {goldens[-1]}")

    pasm = ParityAssembler(parity_config(PARITY_E2E), device=device)
    reset_peaks(cards)
    reset_launch_counts()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        big = {"clean_padded": pool.submit(pasm.assemble, parity_runs["ids"], engine="native",
                                           mesh=mesh, routing="padded"),
               "dirty_ragged": pool.submit(pasm.assemble, parity_runs["dirty_ids"],
                                           engine="native", mesh=mesh, routing="ragged")}
        big = {name: run.result() for name, run in big.items()}
    big_wall = time.perf_counter() - t0
    no_kernel_launched("mesh_e2e parity")
    big_run = dict(
        clean_padded_equal_parity_e2e=big["clean_padded"][0] == parity_runs["lines"],
        dirty_ragged_equal_parity_dirty=big["dirty_ragged"][0] == parity_runs["dirty_lines"],
        side_by_side_wall_seconds=big_wall, max_memory_allocated_by_card=peaks(cards),
        phase_seconds={name: dict(out[1].wall_s) for name, out in big.items()})
    if not (big_run["clean_padded_equal_parity_e2e"]
            and big_run["dirty_ragged_equal_parity_dirty"]):
        raise AssertionError(f"mesh_e2e: BASELINE.md's big run over the mesh differs: {big_run}")

    # mesh2_e2e's process launches start beside this phase's: neither times them
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, concurrent.futures.ThreadPoolExecutor(1) as pool:
        mesh2_procs = pool.submit(mesh2_processes, tmp)
        launched = run_multihost_launches()
        mesh2_procs = mesh2_procs.result()
    t_launches = time.perf_counter() - t0
    multihost = []
    for (procs, backend, spec), got in launched:
        ref_mesh = mesh_lib.make_mesh(procs, devices=cards if spec == "cuda" else [spec])
        ref = run_multihost.summarize(ref_mesh, **MULTIHOST_DATASET)
        same = {key: got[key] == ref[key] for key in (
            "entries", "digest", "ragged_digest", "n_unitigs", "unitig_digest", "overflow")}
        multihost.append(dict(processes=procs, backend=backend, device=spec, equal=same,
                              summary=got, one_process_phase_seconds=ref["phase_seconds"]))
        if (not all(same.values()) or got["overflow"] or got["processes"] != procs
                or got["ragged_digest"] != got["digest"]):
            raise AssertionError(f"mesh_e2e: run_multihost differs: {multihost[-1]}")
    emit("mesh_e2e", n_shards=MESH_SHARDS, devices=[str(d) for d in devices],
         preset="ecoli", reads=len(reads), window_slots=full["fields"]["window_slots"],
         k1_launches=mesh_k1, k1_on_shard_rows=shard_scans, padded=padded, ragged=ragged,
         parity_goldens=goldens,
         parity_big_run=big_run, multihost_dataset=MULTIHOST_DATASET,
         multihost=multihost, process_launches_seconds=t_launches,
         process_launches_with="mesh2_e2e's, side by side")
    torch.cuda.empty_cache()
    return mesh_k1, scan_tally, batch, mesh2_procs


def mesh2_reckoning(n_slots, shape, slack=4.0):
    """The two-level count's padded blocks at RECORD_BYTES a slot, reckoned
    before the run: stage 1 ``n_ici`` blocks of ``ceil(n_local / n_ici *
    slack)`` a shard, stage 2 ``n_slices`` of ``ceil(n_local / n_slices *
    slack)``; the flat count's blocks; and the peak reckoned: the flat
    count's measured peak with the stage-1 blocks beside it (the case where
    no lane were freed before stage 2 allocated)."""
    n = int(np.prod(shape))
    n_local = n_slots // n
    n_slices, n_ici = shape[0], n // shape[0]
    stage1 = n * n_ici * int(np.ceil(n_local / n_ici * slack)) * RECORD_BYTES
    stage2 = n * n_slices * int(np.ceil(n_local / n_slices * slack)) * RECORD_BYTES
    flat = n * n * int(np.ceil(n_local / n * slack)) * RECORD_BYTES
    return dict(stage1_block_bytes=stage1, stage2_block_bytes=stage2, flat_block_bytes=flat,
                reckoned_peak_bytes=FLAT_MESH_PEAK_BYTES + stage1,
                fits=FLAT_MESH_PEAK_BYTES + stage1 <= CARD_BYTES)


def table_rows(sc, mesh):
    """A sharded count as it must match row for row, with the rows that
    hold no record folded: for every field and shard, the rows up to the
    second row past the records (on the host: the records sort first, then
    the one group of FILLS rows), whether every later row equals that last
    one, and the shard's row count.  Two counts are equal row for row,
    every field, exactly when these are equal and every flag is true."""
    out = {}
    for name in shard_count.ShardedCount._fields[:-1]:
        for s, (x, valid) in enumerate(zip(getattr(sc, name), sc.valid)):
            n = int(valid.sum()) + 1
            out[name, s] = (x[:n + 1].cpu(), bool((x[n:] == x[n]).all()) if x.shape[0] > n else True,
                            x.shape[0])
    return out


def mesh2_count(device, cards, batch, shape):
    """The flat padded count of ``batch`` over prod(shape) shards, then the
    two-level count over ``shape`` (stage walls kept), held to it row for
    row, every field of every shard (``table_rows``); K1 == its plain
    version on each shard's rows."""
    n = int(np.prod(shape))
    devices = cards if len(cards) >= n else [device]
    flat_mesh = mesh_lib.make_mesh(n, devices=devices)
    tl_mesh = mesh_lib.make_mesh(devices=devices, shape=shape)
    cfg = ecoli_config()
    kw = dict(k=cfg.k, m=cfg.m, parity=False, cutoff=cfg.abundance_cutoff)
    reckoned = mesh2_reckoning(batch.codes.shape[0] * (cfg.max_read_len - cfg.k + 1), shape)
    if not reckoned["fits"]:
        raise AssertionError(f"mesh2_e2e: the reckoned peak does not fit the card: {reckoned}; "
                             "halve the read set")
    flat, f_wall, f_peak, f_launches = timed_mesh(cards, lambda: shard_count.sharded_count(
        batch.codes, batch.lengths, batch.read_ids, mesh=flat_mesh, **kw))
    f_overflow = flat_mesh.total(flat.overflow)
    t0 = time.perf_counter()
    held = table_rows(flat, flat_mesh)
    del flat
    torch.cuda.empty_cache()
    fold_s = time.perf_counter() - t0
    walls = {}
    two, t_wall, t_peak, t_launches = timed_mesh(
        cards, lambda: two_level.sharded_count_two_level(
            batch.codes, batch.lengths, batch.read_ids, mesh=tl_mesh, walls=walls, **kw))
    t_overflow = tl_mesh.total(two.overflow)
    rows = two.mmer[0].shape[0]
    kept = tl_mesh.total([x.sum() for x in two.keep])
    t0 = time.perf_counter()
    got = table_rows(two, tl_mesh)
    del two
    torch.cuda.empty_cache()
    differ = [f"{name}[{s}]" for (name, s), (head, tail_same, length) in held.items()
              if not (torch.equal(head, got[name, s][0]) and tail_same and got[name, s][1]
                      and length == got[name, s][2])]
    compare_s = time.perf_counter() - t0
    del held, got
    shard_scans = []
    for s, (codes, lengths) in enumerate(zip(tl_mesh.shard_rows(batch.codes),
                                             tl_mesh.shard_rows(batch.lengths))):
        mism, err = compare_scan(codes, lengths, cfg.k, cfg.m)
        shard_scans.append(dict(shard=s, shape=list(codes.shape), mismatches=mism,
                                max_abs_err=err))
        del codes, lengths
    torch.cuda.empty_cache()
    out = dict(
        shape=list(shape), devices=[str(d) for d in devices], rows_a_shard=rows, kept=kept,
        equal_row_for_row=not differ, differing=differ, **reckoned,
        flat=dict(wall_seconds=f_wall, max_memory_allocated_by_card=f_peak, overflow=f_overflow,
                  k1_launches=f_launches["fast_scan"], fold_seconds=fold_s),
        two_level=dict(wall_seconds=t_wall, stage_seconds=walls,
                       max_memory_allocated_by_card=t_peak, overflow=t_overflow,
                       k1_launches=t_launches["fast_scan"], fold_and_compare_seconds=compare_s),
        k1_on_shard_rows=shard_scans)
    if (differ or f_overflow or t_overflow or f_launches["fast_scan"] != n
            or t_launches["fast_scan"] != n
            or any(x["mismatches"] for x in shard_scans)
            or any(sort_kernel_launches(t_launches).values())):
        raise AssertionError(f"mesh2_e2e: the two-level count over {shape}: {out}")
    return out


def mesh2_links(device, cards, full):
    """The two-level links join over (2, 2) on full_e2e's kept keys ==
    part_dbg's flat join over 4 shards, link for link."""
    devices = cards if len(cards) >= 4 else [device]
    kept = torch.from_numpy(full["kept"])
    n = -(-kept.shape[0] // 4) * 4
    kmer = torch.full((n,), SENTINEL, dtype=torch.int64)
    kmer[:kept.shape[0]] = kept
    valid = torch.arange(n) < kept.shape[0]
    k = ecoli_config().k
    out = {}
    for name, mesh, fn in (
            ("flat", mesh_lib.make_mesh(4, devices=devices),
             part_dbg.partitioned_unitig_links_join),
            ("two_level", mesh_lib.make_mesh(devices=devices, shape=(2, 2)),
             two_level.partitioned_unitig_links_join_two_level)):
        (links, ovf), wall, peak, _ = timed_mesh(
            cards, lambda: fn(mesh.shard_rows(kmer), mesh.shard_rows(valid), k=k, mesh=mesh))
        out[name] = dict(links=[x.cpu() for x in links], overflow=mesh.total(ovf),
                         wall_seconds=wall, max_memory_allocated_by_card=peak)
    equal = all(torch.equal(a, b) for a, b in zip(out["flat"].pop("links"),
                                                  out["two_level"].pop("links")))
    res = dict(kept_keys=int(kept.shape[0]), equal=equal, **out)
    if not equal or out["flat"]["overflow"] or out["two_level"]["overflow"]:
        raise AssertionError(f"mesh2_e2e: the two-level links join differs: {res}")
    return res


def run_tool(module, args, timeout):
    """``python -m module *args`` from the repo root: (exit code, seconds,
    stdout, stderr tail).  Killed at ``timeout``."""
    root = pathlib.Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", module, *map(str, args)], cwd=str(root),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return proc.returncode, time.perf_counter() - t0, out, err[-3000:]


def ckpt_flags(ckpt_dir):
    return ["--ckpt-dir", ckpt_dir, "--device", "cuda:0", "--backend", "gloo",
            "--timeout", CKPT_TIMEOUT, *[arg for name, value in CKPT_DATASET.items()
                                         for arg in (f"--{name.replace('_', '-')}", value)]]


def mesh2_processes(tmp):
    """(c) and (d), four chains of launches side by side: run_multihost.py
    over 4 gloo processes on card 0; the checkpointed count over 2
    processes killed after batch 2 (rank 1), then relaunched; the same
    count uninterrupted; the elastic supervisor from 3 processes, rank 2
    killed after batch 1.  Returns each chain's results; a launch that
    fails as it should not fails the phase."""
    mh_out = pathlib.Path(tmp) / "mh4.json"
    dataset = [arg for name, value in MULTIHOST_DATASET.items()
               for arg in (f"--{name.replace('_', '-')}", value)]

    def multihost():
        rc, wall, _, err = run_tool("genome_assembly_tpu_torch.tools.run_multihost",
                                    ["--procs", 4, "--backend", "gloo", "--device", "cuda:0",
                                     "--out", mh_out, "--timeout", MULTIHOST_TIMEOUT, *dataset],
                                    MULTIHOST_TIMEOUT + 60)
        if rc:
            raise AssertionError(f"mesh2_e2e: run_multihost over 4 processes: exit {rc}\n{err}")
        return dict(launch_seconds=wall, summary=json.loads(mh_out.read_text()))

    module = "genome_assembly_tpu_torch.tools.run_multihost_ckpt"

    def kill_and_resume():
        ck = pathlib.Path(tmp) / "ck"
        rc_k, wall_k, _, err_k = run_tool(
            module, ["--procs", 2, *ckpt_flags(ck), "--die-after-batch", 2, "--die-rank", 1],
            CKPT_TIMEOUT + 60)
        killed_manifest = json.loads((ck / "manifest.json").read_text())
        rc_r, wall_r, out_r, err_r = run_tool(module, ["--procs", 2, *ckpt_flags(ck)],
                                              CKPT_TIMEOUT + 60)
        if rc_k == 0 or "exit -9" not in err_k or rc_r:
            raise AssertionError(f"mesh2_e2e: kill and resume: exits {rc_k}, {rc_r}\n"
                                 f"{err_k}\n{err_r}")
        return dict(killed_launch_seconds=wall_k, killed_manifest=killed_manifest,
                    resumed_launch_seconds=wall_r,
                    resumed=json.loads(out_r.strip().splitlines()[-1]))

    def uninterrupted():
        rc, wall, out, err = run_tool(
            module, ["--procs", 2, *ckpt_flags(pathlib.Path(tmp) / "ck_clean")],
            CKPT_TIMEOUT + 60)
        if rc:
            raise AssertionError(f"mesh2_e2e: the uninterrupted checkpointed count: exit {rc}\n"
                                 f"{err}")
        return dict(launch_seconds=wall, summary=json.loads(out.strip().splitlines()[-1]))

    def elastic():
        out = pathlib.Path(tmp) / "elastic.json"
        flags = ckpt_flags(pathlib.Path(tmp) / "ck_elastic")
        rc, wall, _, err = run_tool(
            "genome_assembly_tpu_torch.tools.run_elastic",
            ["--procs", 3, "--out", out, "--die-after-batch", 1, "--die-rank", 2, *flags],
            2 * CKPT_TIMEOUT + 60)
        if rc:
            raise AssertionError(f"mesh2_e2e: the elastic supervisor: exit {rc}\n{err}")
        return dict(launch_seconds=wall, **json.loads(out.read_text()))

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        runs = {name: pool.submit(fn) for name, fn in (
            ("multihost", multihost), ("kill_and_resume", kill_and_resume),
            ("uninterrupted", uninterrupted), ("elastic", elastic))}
        runs = {name: run.result() for name, run in runs.items()}
    runs["kill_and_resume"]["kill_costs_seconds"] = (
        runs["kill_and_resume"]["killed_launch_seconds"]
        + runs["kill_and_resume"]["resumed_launch_seconds"]
        - runs["uninterrupted"]["launch_seconds"])
    return runs


def bench_scaling(routing):
    """The CLI's bench-scaling on the card, 1, 2, 4 shards: its JSON lines."""
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = cli.main(["bench-scaling", "--devices", "4", "--routing", routing,
                       "--batch-reads", str(BENCH_SCALING_READS)])
    rows = [json.loads(line) for line in text.getvalue().splitlines()]
    if rc or [r["shards"] for r in rows] != [1, 2, 4]:
        raise AssertionError(f"mesh2_e2e: bench-scaling --routing {routing}: {rc}, {rows}")
    return rows


def phase_mesh2_e2e(device, full, batch, procs):
    """The second multi-device phase: (a) the two-level count of mesh_e2e's
    batch (the ecoli reads as one batch) over (2, 2) and (2, 2, 2) == the
    flat count of as many shards, row for row, every field, K1 once a shard
    and == its plain version on each shard's rows; (b) the two-level links
    join over (2, 2) on full_e2e's kept keys == the flat 4-shard join;
    (c) run_multihost.py over 4 gloo processes on card 0, two_level_digest
    == digest; (d) the checkpointed count killed and resumed, and the
    elastic supervisor's 3 -> 2 worlds, each == the uninterrupted count;
    (e) bench-scaling with two_level and padded routing.  Every overflow 0.
    ``procs``: ``mesh2_processes``' results ((c) and (d)), launched beside
    mesh_e2e's processes.  Returns the K1 launches of the two-level counts and K1's tally against
    its plain version."""
    cards = card_devices()
    counts = [mesh2_count(device, cards, batch, shape) for shape in MESH2_SHAPES]
    links = mesh2_links(device, cards, full)
    bench = {routing: bench_scaling(routing) for routing in ("two_level", "padded")}
    torch.cuda.empty_cache()

    ref_mesh = mesh_lib.make_mesh(4, devices=[device])
    mh_ref = run_multihost.summarize(ref_mesh, **MULTIHOST_DATASET, two_level=mesh_lib.make_mesh(
        devices=[device], shape=(2, 2)))
    mh = procs["multihost"]["summary"]
    batches = run_multihost_ckpt.batches_of(**CKPT_DATASET)
    ckpt_mesh = mesh_lib.make_mesh(2, devices=[device])
    ckpt_ref = run_multihost.table_digest(shard_count.sharded_count_batches(
        batches, k=CKPT_DATASET["k"], m=CKPT_DATASET["m"], parity=False,
        cutoff=CKPT_DATASET["cutoff"], mesh=ckpt_mesh), ckpt_mesh, CKPT_DATASET["k"],
        CKPT_DATASET["m"])
    kr, el, clean = procs["kill_and_resume"], procs["elastic"], procs["uninterrupted"]["summary"]
    checks = dict(
        multihost_two_level_digest_equal=mh["two_level_digest"] == mh["digest"],
        multihost_equal_one_process=all(mh[key] == mh_ref[key] for key in (
            "entries", "digest", "two_level_digest", "n_unitigs", "unitig_digest")),
        multihost_overflow_0=mh["overflow"] == 0,
        killed_at_batch_2=kr["killed_manifest"]["batches_done"] == 2,
        resumed_from_2=kr["resumed"]["resumed_from"] == 2,
        resumed_equal_uninterrupted=(kr["resumed"]["entries"], kr["resumed"]["digest"])
        == ckpt_ref == (clean["entries"], clean["digest"]),
        elastic_attempts=el["attempts"] == [3, 2],
        elastic_resumed_from_1=el["summary"]["resumed_from"] == 1,
        elastic_equal_uninterrupted=(el["summary"]["entries"], el["summary"]["digest"])
        == ckpt_ref,
        ckpt_overflow_0=kr["resumed"]["overflow"] == el["summary"]["overflow"] == 0,
        at_least_6_batches=len(batches) >= 6)
    emit("mesh2_e2e", preset="ecoli", reads=batch.n,
         window_slots=batch.codes.shape[0] * (batch.codes.shape[1] - ecoli_config().k + 1),
         counts=counts, links=links, bench_scaling=bench, processes=procs,
         processes_launched_in="mesh_e2e", ckpt_dataset=CKPT_DATASET, ckpt_batches=len(batches),
         ckpt_reference=list(ckpt_ref), checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"mesh2_e2e: {checks}")
    torch.cuda.empty_cache()
    tally = [x for c in counts for x in c["k1_on_shard_rows"]]
    return (sum(c["two_level"]["k1_launches"] for c in counts),
            (sum(x["mismatches"] for x in tally), max(x["max_abs_err"] for x in tally)))


# --------------------------------------------------------------------------
# the primitive probe, the communication model, the runner's ext modes
# --------------------------------------------------------------------------

def phase_prims(device):
    """The port's tools/bench_prims.py in process, on the card: its lines
    printed as it goes; a lane gather that differs raises there.  Returns
    K5's launches in it (the counts set to 0 just before, read just after)."""
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    lines = bench_prims.main([], emit=lambda line: emit(
        "prims", probe=line["phase"], **{f: v for f, v in line.items() if f != "phase"}))
    torch.cuda.synchronize()
    launches = read_launch_counts()
    emit("prims_done", seconds=time.perf_counter() - t0, launches=launches,
         probes=[line["phase"] for line in lines])
    if not launches["lane_gather"] or any(
            n for name, n in launches.items() if name not in ("lane_gather",)):
        raise AssertionError(f"prims: launches {launches}, want K5 and no other kernel")
    return launches["lane_gather"]


# the link bandwidths the model is priced with (required arguments: one card
# cannot measure them): NVLink 4 of an H100 SXM, 450 GB/s each way (NVIDIA's
# data sheet), and a 400 Gb/s network port a card (NDR InfiniBand)
NVLINK_BYTES_PER_S = 450e9
NETWORK_BYTES_PER_S = 50e9
COPY_BYTES = 1 << 30


def measured_rates(device, full, batch):
    """The single-card rates behind comm_model's H100_* constants, each with
    its source: the count of mesh_e2e's ecoli batch, full_e2e's links wall,
    and timings here on the ecoli kept keys (CUDA events, warm medians; host
    clock for the launch overhead and the copies)."""
    k = ECOLI["k"]
    sec = full["fields"]["phase_seconds"]
    codes = torch.from_numpy(batch.codes).to(device)
    lengths = torch.from_numpy(batch.lengths).to(device)
    windows = int((lengths.long() - k + 1).clamp(min=0).sum())

    def count():
        recs = minimizer.fast_scan(codes, lengths, k=k, m=ECOLI["m"])
        return count_ops.kept_keys_sorted(count_ops.count_keys(recs, cutoff=ECOLI["cutoff"]))
    runs = timed_ms_runs(count, reps=5)
    del codes, lengths
    torch.cuda.empty_cache()
    kept = torch.from_numpy(full["kept"]).to(device)
    n = kept.shape[0]
    rates = {
        "count_records_per_s": dict(
            value=windows / (statistics.median(runs) * 1e-3),
            per_run=[windows / (ms * 1e-3) for ms in runs],
            full_e2e_host_walls=full["fields"]["kmers_counted_per_s"],
            source=f"valid windows ({windows}) / fast_scan + count_keys + kept_keys_sorted "
                   f"of mesh_e2e's ecoli batch {list(batch.codes.shape)} on one card, "
                   "CUDA events, median of 5 warm runs"),
        "link_records_per_s": dict(value=4 * n / sec["links"],
                                   source="full_e2e: 4 x kept keys / links"),
    }
    valid = torch.ones(n, dtype=torch.bool, device=device)
    links = dbg.build_unitig_links_join(kept, valid, k=k)
    table, _ = dbg._jump_init(links, lanes=3)
    ms = timed_ms(lambda: dbg._jump_rows(table, table))
    rates["jump_states_per_s"] = dict(value=links.shape[0] / (ms * 1e-3),
                                      source="one doubling round (_jump_rows, 3 lanes) over "
                                             f"full_e2e's {links.shape[0]} states")
    del table
    # one chunk of the parked link build at chr1's plan: 2^23 nodes (the ecoli
    # keys padded as build_unitig_links_parked pads its last chunk), 12 partitions
    chunk = 1 << 23
    kc = torch.full((chunk,), SENTINEL, dtype=torch.int64, device=device)
    kc[:n] = kept
    vc = torch.arange(chunk, device=device) < n
    cap_bp, group = outofcore.range_group_plan(CHR1_LINK_CHUNKS, 4 * chunk,
                                               partitions=CHR1_LINK_PARTITIONS,
                                               bytes_per_record=12,
                                               budget_bytes=dbg.LINK_GROUP_BUDGET_BYTES,
                                               sigma_scale=2.9)

    def extract():
        key, pay = dbg._chunk_boundary_records(kc, vc, 0, k=k)
        return outofcore.extract_partition_range3(key, pay, 0, partitions=CHR1_LINK_PARTITIONS,
                                                  group_size=group, cap_bp=cap_bp)
    ms = timed_ms(extract, reps=5)
    rates["extract_rows_per_s"] = dict(value=4 * chunk / (ms * 1e-3),
                                       source=f"boundary records + extraction of one chunk of "
                                              f"{chunk} nodes, group {group} of "
                                              f"{CHR1_LINK_PARTITIONS} partitions")
    key, pay = dbg._chunk_boundary_records(kept, valid, 0, k=k)
    ms = timed_ms(lambda: dbg._partition_edges(key, pay), reps=5)
    rates["join_rows_per_s"] = dict(value=key.shape[0] / (ms * 1e-3),
                                    source=f"sort-join of full_e2e's {key.shape[0]} link records "
                                           "as one partition")
    src, dst = dbg._partition_edges(key, pay)
    next_state = torch.full((2 * n + 1,), -1, dtype=torch.int64, device=device)
    ms = timed_ms(lambda: dbg._scatter_edges(next_state, src, dst), reps=5)
    rates["scatter_rows_per_s"] = dict(value=src.shape[0] / (ms * 1e-3),
                                       source=f"edge scatter of {src.shape[0]} rows")
    del key, pay, src, dst, next_state, kc, vc, links
    # the host's cost of a launch: 2000 small launches, then one synchronise
    x = torch.zeros(1, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        x.add_(1)
    rates["launch_s"] = dict(value=(time.perf_counter() - t0) / 2000,
                             source="host seconds of one launch, 2000 in a row")
    torch.cuda.synchronize()
    # copies of 1 GiB: pageable numpy (the parked link build's) and pinned
    host = np.ones(COPY_BYTES // 8, dtype=np.int64)
    pinned = torch.empty(COPY_BYTES // 8, dtype=torch.int64).pin_memory()
    on_card = torch.empty(COPY_BYTES // 8, dtype=torch.int64, device=device)

    def host_timed(fn, reps=3):
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times[1:])
    for name, fn, what in (
            ("upload_bytes_per_s", lambda: torch.from_numpy(host).to(device),
             "pageable numpy -> card (.to)"),
            ("readback_bytes_per_s", lambda: on_card.cpu(), "card -> pageable (.cpu())"),
            ("pinned_upload_bytes_per_s", lambda: on_card.copy_(pinned, non_blocking=True),
             "pinned -> card"),
            ("pinned_readback_bytes_per_s", lambda: pinned.copy_(on_card, non_blocking=True),
             "card -> pinned")):
        rates[name] = dict(value=COPY_BYTES / host_timed(fn), source=f"1 GiB, {what}")
    del host, pinned, on_card, kept, valid
    torch.cuda.empty_cache()
    return rates


def phase_comm_model(device, full, batch):
    """comm_model on the card.  The count matrix of mesh_e2e's ecoli batch
    over 4 shards (both routings): its column sums == the records each shard
    received in the padded ``sharded_count``, its row sums == each shard's
    valid windows (from the read lengths); the links matrix of full_e2e's
    kept keys: row sums == 4 x each shard's nodes; the jump matrices of
    their links, whose peak is the routed jump's exact capacity (a slack of
    that many requests a pair runs clean, one fewer overflows); the rates
    behind the H100_* constants; bench_scaling_model on its defaults."""
    t_phase = time.perf_counter()
    k, m = ECOLI["k"], ECOLI["m"]
    n_shards = MESH_SHARDS
    cards = card_devices()
    devices = cards if len(cards) > 1 else [device]
    mesh = mesh_lib.make_mesh(n_shards, devices=devices)
    lengths = torch.from_numpy(batch.lengths.astype(np.int64))
    windows = (lengths - k + 1).clamp(min=0).reshape(n_shards, -1).sum(dim=1).numpy()
    out, checks = {}, {}
    for route_by in ("mmer", "key"):
        mat, t_mat, mat_peak = timed_call(lambda: comm_model.count_exchange_matrix(
            batch.codes, batch.lengths, k=k, m=m, n_shards=n_shards, route_by=route_by,
            device=device))
        torch.cuda.empty_cache()
        sc, t_sc, _ = timed_call(lambda: shard_count.sharded_count(
            batch.codes, batch.lengths, batch.read_ids, k=k, m=m, parity=False, cutoff=1,
            mesh=mesh, route_by=route_by))
        received = [int(v.sum()) for v in sc.valid]
        overflow = mesh.total(sc.overflow)
        del sc
        torch.cuda.empty_cache()
        out[f"count_{route_by}"] = dict(matrix=mat.tolist(), seconds=t_mat, peak_bytes=mat_peak,
                                        sharded_count_seconds=t_sc, received=received)
        checks[f"count_{route_by}_columns_equal_received"] = (
            overflow == 0 and mat.sum(axis=0).tolist() == received)
        checks[f"count_{route_by}_rows_equal_windows"] = mat.sum(axis=1).tolist() == windows.tolist()
    kept = torch.from_numpy(full["kept"])
    n = -(-kept.shape[0] // n_shards) * n_shards
    kmer = torch.full((n,), SENTINEL, dtype=torch.int64)
    kmer[:kept.shape[0]] = kept
    kmer, valid = kmer.to(device), (torch.arange(n) < kept.shape[0]).to(device)
    lmat, t_lmat, _ = timed_call(lambda: comm_model.links_exchange_matrix(
        kmer, valid, k=k, n_shards=n_shards))
    nodes = valid.reshape(n_shards, -1).sum(dim=1).cpu().numpy()
    checks["links_rows_equal_4_nodes"] = (lmat.sum(axis=1) == 4 * nodes).all() and \
        int(lmat.sum()) == 4 * int(kept.shape[0])
    links = dbg.build_unitig_links_join(kmer, valid, k=k)
    (pred, rounds, final), t_jmat, _ = timed_call(lambda: comm_model.jump_request_matrices(
        links, n_shards=n_shards))
    peak = max(int(x.max()) for x in [pred, final, *rounds])
    rows2 = links.shape[0] // n_shards
    jump_mesh = mesh_lib.make_mesh(n_shards, devices=devices)
    shards = jump_mesh.shard_rows(links)
    overflows = {}
    for cap in (peak, peak - 1):
        _, ovf = part_dbg.partitioned_pointer_jump(shards, mesh=jump_mesh,
                                                   slack=cap * n_shards / rows2)
        overflows[cap] = jump_mesh.total(ovf)
    checks["jump_peak_is_the_exact_capacity"] = overflows[peak] == 0 < overflows[peak - 1]
    checks["jump_rounds"] = len(rounds) == part_dbg.jump_rounds(links.shape[0])
    out["links"] = dict(matrix=lmat.tolist(), seconds=t_lmat, kept_keys=int(kept.shape[0]))
    out["jump"] = dict(states=int(links.shape[0]), rounds=len(rounds), seconds=t_jmat,
                       pred_requests=int(pred.sum()),
                       round_requests=[int(x.sum()) for x in rounds],
                       final_requests=int(final.sum()), peak_pair_requests=peak,
                       overflow_at_peak=overflows[peak], overflow_below=overflows[peak - 1])
    del kmer, valid, links, shards
    torch.cuda.empty_cache()
    rates = measured_rates(device, full, batch)
    emit("comm_model_rates", card=nvidia_smi_line(), rates=rates)
    t0 = time.perf_counter()
    model = bench_scaling_model.main(
        ["--link-bytes-per-s", str(NVLINK_BYTES_PER_S),
         "--network-bytes-per-s", str(NETWORK_BYTES_PER_S)],
        emit=lambda line: emit("bench_scaling_model", **line))
    out["bench_scaling_model"] = dict(seconds=time.perf_counter() - t0, rows=len(model),
                                      link_bytes_per_s=NVLINK_BYTES_PER_S,
                                      network_bytes_per_s=NETWORK_BYTES_PER_S)
    checks["bench_scaling_model_rows"] = [r["shards"] for r in model] == [8, 16, 64, 256]
    checks = {name: bool(v) for name, v in checks.items()}
    emit("comm_model", n_shards=n_shards, reads=batch.n, **out, checks=checks,
         seconds=time.perf_counter() - t_phase)
    if not all(checks.values()):
        raise AssertionError(f"comm_model: {checks}")


EXT_MODE_ARGS = ["--preset", SCALE_CHECK_PRESET, "--materialize"]


def phase_ext_modes(device):
    """run_scale.main in process at the ecoli preset with --ext-mode bulk and
    part (wide is part's alias): part gives bulk's linear unitigs, cyclic
    states, longest chain and materialized strings (count, total bp),
    overflows 0."""
    t_phase = time.perf_counter()
    runs = {}
    for mode in ("bulk", "part"):
        events = []
        torch.cuda.empty_cache()
        rc, k1, _, wall = counted(lambda: run_scale.main(
            EXT_MODE_ARGS + ["--ext-mode", mode], emit_event=events.append))
        ev = {e["event"]: e for e in events}
        runs[mode] = dict(
            exit_code=rc, wall_seconds=wall, k1_launches=k1,
            extension={f: ev["extension"][f] for f in (
                "wall_s", "linear_unitigs", "cyclic_states", "longest_chain",
                "peak_device_bytes")},
            materialize={f: ev["materialize"][f] for f in ("unitigs", "total_bp", "longest_bp",
                                                           "wall_s")})
        if mode != "bulk":
            runs[mode].update(links={f: ev["links"][f] for f in (
                "wall_s", "mode", "overflow", "peak_device_bytes")},
                jump={f: ev["jump"][f] for f in (
                    "wall_s", "mode", "overflow", "jump_rounds", "peak_device_bytes")})
    graph = ("linear_unitigs", "cyclic_states", "longest_chain")
    strings = ("unitigs", "total_bp", "longest_bp")
    checks = {}
    for mode in ("part",):
        r, b = runs[mode], runs["bulk"]
        checks[f"{mode}_graph_equal_bulk"] = all(
            r["extension"][f] == b["extension"][f] for f in graph)
        checks[f"{mode}_strings_equal_bulk"] = all(
            r["materialize"][f] == b["materialize"][f] for f in strings)
        checks[f"{mode}_overflow_0"] = r["links"]["overflow"] == r["jump"]["overflow"] == 0
        checks[f"{mode}_reported_as_{mode}"] = r["links"]["mode"] == r["jump"]["mode"] == mode
    checks["exit_codes"] = all(r["exit_code"] == 0 for r in runs.values())
    emit("ext_modes", args=EXT_MODE_ARGS, runs=runs, checks=checks,
         seconds=time.perf_counter() - t_phase)
    if not all(checks.values()):
        raise AssertionError(f"ext_modes: {checks}")


# clock cycles of the spin that holds the stream while the probe shapes'
# launches are queued behind it (about 10 ms at the H100's clocks, far longer
# than the host takes to queue 50 launches)
SPIN_CYCLES = 20_000_000


HOST_ROUNDS = 21


def host_us(fns, calls, rounds=HOST_ROUNDS, warm=2):
    """{name: median µs of the host's own work for one call of fns[name]}.
    A block is `calls` calls of one fn queued behind a spin of SPIN_CYCLES
    (so the card never holds the host back) with no synchronise inside,
    timed by the host clock from its first call to the return of its last
    and divided by `calls`.  Each of `rounds` rounds times one block of
    every fn in turn, so the host's slow spells fall on all of them."""
    for fn in fns.values():
        for _ in range(warm):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            torch.cuda._sleep(SPIN_CYCLES)
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times[name].append((time.perf_counter() - t0) * 1e6 / calls)
            torch.cuda.synchronize()
    return {name: statistics.median(t) for name, t in times.items()}


def time_lane_gather(device, launches, tally):
    """K5 at [65536, 1024] int32 (and int64 beside it) and at the probe's
    shapes, turn about with its plain version; torch.gather (int64 indices:
    the library takes no other) as the library call.  At the probe's shapes
    the kernel and the library are also timed queued behind a spin
    (``device_ms``, ``library_device_ms``): the card's work alone, where
    ``ms`` and ``library_ms`` are bound by the host's launch path; and the
    host's own work a call (``host_us``, ``library_host_us``).  Bound:
    bytes, x and idx read once and out written once."""
    gen = torch.Generator(device=device)
    gen.manual_seed(13)

    def one(shape, dtype, kernel_calls, queued=False):
        x, idx = lane_gather_input(gen, shape, dtype, "random", device)
        idx64 = idx.long()
        kernel = lambda: lane_gather_cuda.lane_gather_cuda(x, idx)  # noqa: E731
        library = lambda: torch.gather(x, 1, idx64)  # noqa: E731
        times = turn_about(kernel, lambda: lane_gather.lane_gather_plain(x, idx),
                           kernel_calls=kernel_calls)
        times["library_ms"] = timed_ms(library, calls=kernel_calls)
        if queued:
            for name, fn in (("device_ms", kernel), ("library_device_ms", library)):
                times[name] = statistics.median(timed_ms_runs(
                    fn, calls=kernel_calls, spin_cycles=SPIN_CYCLES))
            host = host_us({"wrapper": kernel, "library": library}, kernel_calls)
            times.update(host_us=host["wrapper"], library_host_us=host["library"],
                         host_rounds=HOST_ROUNDS)
        n_bytes = 3 * x.numel() * x.element_size()
        times.update(shape=list(shape), dtype=str(dtype).split(".")[-1],
                     bound_ms=n_bytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
                     bound_bytes_ms=n_bytes / PEAK_BYTES_PER_S * 1e3, bound_operations_ms=0.0)
        return times

    main = one((65536, 1024), torch.int32, 10)
    at_int64 = one((65536, 1024), torch.int64, 10)
    probes = [one((256, cols), torch.int32, 50, queued=True) for cols in (128, 1024)]
    return {
        "name": "lane_gather", "route": "cuda",
        "source": "genome_assembly_tpu_torch/csrc/lane_gather.cu",
        "host_path": "torch operator ga_torch::lane_gather",
        "host_source": "genome_assembly_tpu_torch/csrc/lane_gather_op.cpp",
        "replaces": "tools/bench_prims.py:145",
        "launches": launches, "launches_from": "prims (tools/bench_prims.py on the card)",
        "max_abs_err": tally[1], "mismatches": tally[0],
        **main, "kernel_ms": main["ms"], "at_int64": at_int64, "at_probe_shapes": probes,
    }


# --------------------------------------------------------------------------
# out of core
# --------------------------------------------------------------------------

@contextlib.contextmanager
def reextractions():
    """Yields a list that gets one entry for each partition re-extracted
    alone (the self-heal, ``outofcore._reextract``) while the block runs:
    what re-extracted it ("count" or "link"), the partition, the units its
    sweeps made again (a count's unit is a batch, each one K1 launch; the
    units of a sweep that stopped on an overflow included), the records it
    returned and its seconds."""
    real = outofcore._reextract
    log = []

    def counted(records, n_units, p, **kw):
        made = [0]

        def unit(u):
            made[0] += 1
            return records(u)
        t0 = time.perf_counter()
        lanes = real(unit, n_units, p, **kw)
        torch.cuda.synchronize()
        log.append(dict(what=kw["what"], partition=p, units_made=made[0],
                        records=int(lanes[0].shape[0]), seconds=time.perf_counter() - t0))
        return lanes
    outofcore._reextract = counted
    try:
        yield log
    finally:
        outofcore._reextract = real


def count_plan(cfg, n_batches, batch_slots, total_slots):
    """(partitions, cap_bp, group size, passes) that FastAssembler's
    out-of-core branch gives partitioned_count for this read set."""
    partitions = max(1, int(np.ceil(total_slots * 8 / (cfg.outofcore_bytes / 3))))
    cap_bp, G = outofcore.range_group_plan(n_batches, batch_slots, partitions=partitions,
                                           bytes_per_record=8,
                                           budget_bytes=outofcore.GROUP_BUDGET_BYTES)
    return partitions, cap_bp, G, -(-partitions // G)


def healed_scans(healed):
    """The K1 launches of the counts' re-extractions (plain and super)."""
    return sum(h["units_made"] for h in healed if h["what"] in ("count", "super count"))


def timed_unitigs(asm, reads):
    """One FastAssembler.unitigs call with the launch counts and the peak
    memory set to 0 just before it: (unitigs, stats, wall, peak, launches)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out, stats = asm.unitigs(reads)
    torch.cuda.synchronize()
    return (out, stats, time.perf_counter() - t0, torch.cuda.max_memory_allocated(),
            read_launch_counts())


def timed_call(fn):
    """(fn(), seconds, peak) with the peak memory set to 0 just before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def sort_kernel_launches(launches):
    return {name: launches[name] for name in (*bitonic_cuda.launch_count,
                                              *mergepath_cuda.launch_count)}


def group_pass_read_backs(device, cfg, reads, n_batches, cap_bp, partitions):
    """The synchronising CUDA calls of ONE group pass of the count
    (outofcore.stage_group) over the first n_batches batches: the scans,
    the extraction and the staging read back nothing, the pass once."""
    batches = reads_io.batch_reads(reads[: n_batches * cfg.batch_reads], cfg.max_read_len,
                                   cfg.batch_reads)
    asm = FastAssembler(cfg, device=device)
    records = pipeline._batch_source(
        batches, device, lambda b, codes, lengths, rids: (
            asm.counter.scan(codes, lengths).kmer.reshape(-1),))
    (parts, ovf), calls, where = synchronising_calls(lambda: outofcore.stage_group(
        records, n_batches, outofcore.extract_partition_range, 0, partitions=partitions,
        group_size=partitions, cap_bp=cap_bp, dtypes=(torch.int64,)))
    staged = sum(int((lanes[0] != SENTINEL).sum()) for lanes in parts)
    valid = sum(int(asm.counter.scan(codes, lengths).valid.sum())
                for codes, lengths, _ in stream_io.feed_read_batches(batches, device))
    return calls, where, ovf, staged, valid


def phase_ooc_e2e(device):
    """Fast mode out of core at the default limits: a 10 Mb genome at 50x
    with 0.1 % substitution errors, 77 batches, 4 partitions in one group
    pass; held against an in-core run of the same reads (outofcore_bytes
    8 GiB): the same unitig multiset and counters, exactly-once coverage of
    the kept table; K1 launches = 1 (the probe) + passes x batches."""
    p = OOC_E2E
    t0 = time.perf_counter()
    genome, reads = coverage_reads(p["genome_len"], p["read_len"], p["coverage"],
                                   seed=p["seed"], error_rate=p["error_rate"])
    t_reads = time.perf_counter() - t0
    cfg = ecoli_config()
    n_batches = -(-len(reads) // cfg.batch_reads)
    batch_slots = cfg.batch_reads * cfg.windows_per_read
    slots = n_batches * batch_slots
    if slots * 8 <= cfg.outofcore_bytes:
        raise AssertionError(f"ooc_e2e: {slots} slots stay in core at the default limit")
    partitions, cap_bp, G, passes = count_plan(cfg, n_batches, batch_slots, slots)
    with reextractions() as healed:
        out, stats, wall, peak, launches = timed_unitigs(FastAssembler(cfg, device=device), reads)
    want_k1 = 1 + passes * n_batches + healed_scans(healed)
    if launches["fast_scan"] != want_k1:
        raise AssertionError(f"ooc_e2e: {launches['fast_scan']} K1 launches, want {want_k1}")
    if any(sort_kernel_launches(launches).values()):
        raise AssertionError(f"ooc_e2e: the default path launched a sort kernel: {launches}")
    torch.cuda.empty_cache()
    incore_cfg = dataclasses.replace(cfg, outofcore_bytes=INCORE_BYTES)
    in_out, in_stats, in_wall, in_peak, _ = timed_unitigs(
        FastAssembler(incore_cfg, device=device), reads)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    same = dict(
        unitig_multiset=sorted(out) == sorted(in_out),
        counters={f: getattr(stats, f) == getattr(in_stats, f) for f in (
            "n_reads", "entries_pre_prune", "entries_post_prune", "entries_post_extension")},
        window_slots=stats.n_windows == slots)
    kept = kept_table(reads, cfg, device)
    torch.cuda.empty_cache()
    check_exactly_once(out, kept, cfg.k)
    same["kept_table_size"] = kept.size == stats.entries_post_prune
    t_check = time.perf_counter() - t0
    calls, where, ovf, staged, valid = group_pass_read_backs(
        device, cfg, reads, 5, outofcore.range_group_plan(
            5, batch_slots, partitions=partitions, bytes_per_record=8)[0], partitions)
    torch.cuda.empty_cache()
    emit("ooc_e2e", genome_len=p["genome_len"], coverage=p["coverage"], read_len=p["read_len"],
         error_rate=p["error_rate"], reads=len(reads), k=cfg.k, m=cfg.m,
         batch_reads=cfg.batch_reads, n_batches=n_batches, window_slots=slots,
         key_bytes=slots * 8, outofcore_bytes=cfg.outofcore_bytes, partitions=partitions,
         group_size=G, cap_bp=cap_bp, passes=passes, reextracted=healed,
         k1_launches=launches["fast_scan"], k1_launches_expected=want_k1,
         read_generation_host_seconds=t_reads, check_seconds=t_check,
         phase_seconds=dict(stats.wall_s), assemble_wall_seconds=wall,
         max_memory_allocated=peak, incore_phase_seconds=dict(in_stats.wall_s),
         incore_assemble_wall_seconds=in_wall, incore_max_memory_allocated=in_peak,
         peak_bytes_per_window_slot=peak / slots, incore_peak_bytes_per_window_slot=in_peak / slots,
         group_pass_synchronising_calls={"batches": 5, "calls": calls, "from": where,
                                         "staged_equal_valid": staged == valid},
         n_unitigs=len(out), longest_unitig=max(map(len, out)), exactly_once=True,
         equal_to_incore=same, **counters(stats))
    if not (same["unitig_multiset"] and all(same["counters"].values())
            and same["window_slots"] and same["kept_table_size"]):
        raise AssertionError(f"ooc_e2e: out of core and in core differ: {same}")
    if calls != 1 or staged != valid or any(ovf):
        raise AssertionError(f"ooc_e2e: one group pass made {calls} synchronising calls "
                             f"({where}), staged {staged} of {valid} records, overflows {ovf}")


def phase_ooc_extension(device, full, coverage):
    """Every out-of-core switch at once on the ecoli preset's reads
    (full_e2e's): outofcore_bytes 512 MiB (11 partitions), link_budget_bytes
    32 MiB (out-of-core links, 7 partitions), bulk_jump_states 2^20 (bulk
    jump); once by default and once with hybrid_sort (K3b and K3c launched
    by the partition counts).  Unitigs and counters equal full_e2e's.  Then
    pointer_jump_bulk with 8 chunked rounds against pointer_jump on the
    preset's links, and the order of an out-of-core list: card == CPU.
    ``outofcore_bytes`` shrinks with ``--coverage`` (the read set does), so
    the count still goes out of core in 11 partitions."""
    limits = dict(OOC_EXTENSION_LIMITS, outofcore_bytes=OOC_EXTENSION_LIMITS[
        "outofcore_bytes"] * coverage // ECOLI["coverage"])
    reads = full["reads"]
    runs = {}
    for hybrid in (False, True):
        cfg = dataclasses.replace(ecoli_config(hybrid), **limits)
        n_batches = -(-len(reads) // cfg.batch_reads)
        batch_slots = cfg.batch_reads * cfg.windows_per_read
        partitions, cap_bp, G, passes = count_plan(cfg, n_batches, batch_slots,
                                                   n_batches * batch_slots)
        n_nodes = full["counters"]["entries_post_prune"]
        link_parts = int(np.ceil(4 * n_nodes * 12 / cfg.link_budget_bytes))
        if (n_batches * batch_slots * 8 <= cfg.outofcore_bytes or link_parts <= 3
                or 2 * n_nodes <= cfg.bulk_jump_states):
            raise AssertionError("ooc_extension: a limit does not switch its branch")
        with reextractions() as healed:
            out, stats, wall, peak, launches = timed_unitigs(
                FastAssembler(cfg, device=device), reads)
        torch.cuda.empty_cache()
        want = {"fast_scan": 1 + passes * n_batches + healed_scans(healed)}
        if hybrid:
            # a staged partition sorts n_batches * cap_bp keys; a healed
            # one (counted from its re-extraction alone) its true size
            sizes = [n_batches * cap_bp] * partitions
            for h in healed:
                if h["what"] == "count":
                    sizes[h["partition"]] = h["records"]
            passes_of = [hybrid_pass_counts(n, bitonic_sort.DEFAULT_LIB_CHUNK,
                                            bitonic_sort.DEFAULT_CHUNK) for n in sizes]
            want.update(big_ce=sum(b for b, _ in passes_of), finish=sum(f for _, f in passes_of))
        got = {name: launches[name] for name in want}
        others = {n: c for n, c in sort_kernel_launches(launches).items() if n not in want}
        same = (sorted(out) == sorted(full["unitigs"]),
                {f: c for f, c in counters(stats).items() if f != "n_windows"}
                == {f: c for f, c in full["counters"].items() if f != "n_windows"})
        runs["hybrid" if hybrid else "default"] = dict(
            partitions=partitions, group_size=G, cap_bp=cap_bp, passes=passes,
            link_partitions=link_parts, reextracted=healed, launches=got,
            launches_expected=want, phase_seconds=dict(stats.wall_s),
            assemble_wall_seconds=wall, max_memory_allocated=peak,
            equal_to_full_e2e=all(same))
        if not all(same) or any(others.values()) or got != want:
            raise AssertionError(f"ooc_extension (hybrid_sort={hybrid}): equal {same}, "
                                 f"launches {got} want {want}, off the path {others}")
        if hybrid and not (got["big_ce"] and got["finish"]):
            raise AssertionError("ooc_extension: the partition counts never reached the network")
    # the bulk jump with chunked rounds against the fused jump, on the
    # preset's own links
    # (and the peak device bytes of each in-core extension step, a node or
    # a state, beside what it was given: what sizes link_budget_bytes and
    # bulk_jump_states for the card)
    kmer = torch.from_numpy(full["kept"]).to(device)
    base = torch.cuda.memory_allocated()
    links, _, join_peak = timed_call(
        lambda: dbg.build_unitig_links_join(kmer, kmer != SENTINEL, k=ECOLI["k"]))
    base_jump = torch.cuda.memory_allocated()
    bulk, t_bulk, bulk_peak = timed_call(lambda: dbg.pointer_jump_bulk(links, lowmem_chunks=8))
    del bulk
    bulk2, _, bulk2_peak = timed_call(lambda: dbg.pointer_jump_bulk(links))
    fused, _, fused_peak = timed_call(lambda: dbg.pointer_jump(links))
    bulk, _, _ = timed_call(lambda: dbg.pointer_jump_bulk(links, lowmem_chunks=8))
    jump_equal = all(torch.equal(a, b) and torch.equal(b, c)
                     for a, b, c in zip(bulk, fused, bulk2))
    n_nodes = int(kmer.shape[0])
    extension_peaks = dict(
        nodes=n_nodes, join_bytes_per_node=(join_peak - base) / n_nodes,
        pointer_jump_bytes_per_state=(fused_peak - base_jump) / (2 * n_nodes),
        bulk_jump_bytes_per_state=(bulk2_peak - base_jump) / (2 * n_nodes),
        bulk_jump_lowmem_8_bytes_per_state=(bulk_peak - base_jump) / (2 * n_nodes))
    del kmer, links, bulk, bulk2, fused
    torch.cuda.empty_cache()
    # the order of an out-of-core list: the card's equals the CPU's, element
    # for element (small_e2e's reads, every switch thrown)
    _, small, _ = datagen.generate_coverage_reads(
        genome_len=3000, read_len=64, coverage=8, seed=5, with_reverse=True)
    small_cfg = PipelineConfig(k=21, m=7, parity=False, max_read_len=128, batch_reads=128,
                               outofcore_bytes=1 << 16, link_budget_bytes=1 << 12,
                               bulk_jump_states=64)
    on_card, s_card = FastAssembler(small_cfg, device=device).unitigs(small)
    on_cpu, s_cpu = FastAssembler(small_cfg, device="cpu").unitigs(small)
    order_equal = on_card == on_cpu and counters(s_card) == counters(s_cpu)
    emit("ooc_extension", preset="ecoli", same_reads_as="full_e2e", limits=limits, runs=runs,
         bulk_jump_lowmem_chunks_8_equal_pointer_jump=jump_equal,
         bulk_jump_seconds=t_bulk, extension_peaks=extension_peaks,
         small_ooc_list_card_equal_cpu=order_equal,
         small_ooc_unitigs=len(on_card))
    if not jump_equal or not order_equal or not on_card:
        raise AssertionError(f"ooc_extension: bulk jump equal {jump_equal}, "
                             f"small list card == CPU {order_equal}")


def scale_dataset(device, preset=SCALE_CHECK_PRESET):
    """The genome-scale runner's read batches of a preset (k=31, m=7, seed 0,
    virtual genome), made on ``device``."""
    return run_scale.Dataset(preset, k=ECOLI["k"], m=ECOLI["m"], seed=0, virtual=True,
                             device=device)


def expansion_rows(device, n_rows):
    """The first n_rows rebuilt base rows of the runner's ecoli records
    (batches made until there are enough): what K1 scans in one expansion
    chunk of the super-k-mer count."""
    ds = scale_dataset(device)
    lanes, have, b = [], 0, 0
    while have < n_rows:
        recs = ds.super_records(b)
        real = recs[0] != superkmer.FILLS[0]
        lanes.append([x[real] for x in recs])
        have += int(real.sum())
        b += 1
    rows = [torch.cat(x)[:n_rows] for x in zip(*lanes)]
    return superkmer.record_rows(*rows, k=ECOLI["k"])


def counted(fn):
    """(fn(), K1 launches, re-extractions, seconds) with the launch counts
    set to 0 just before fn and read just after."""
    torch.cuda.synchronize()
    reset_launch_counts()
    with reextractions() as healed:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return out, minimizer_cuda.launch_count, healed, wall


def super_k1(pc, n_batches, healed):
    """K1 launches a super count makes: the probe, every batch a pass, the
    batches a self-heal made again, one an expansion chunk."""
    return 1 + pc.passes * n_batches + healed_scans(healed) + pc.expand_chunks


class _Killed(Exception):
    pass


def phase_scale_checks(device):
    """The runner's functions on the ecoli preset (36 batches of 65536 x 128,
    231 M slots, reads made on the card): plain and super-k-mer counts, both
    out of core, keep the same keys; the card's super count equals the
    CPU's, in order, on the first batches; a subrange count forced by a
    smaller SUB_COUNT_SLOTS keeps the same keys; two worker ranges into one
    checkpoint directory merge, with no re-scan, into the fresh list; a jump
    killed after 5 rounds resumes from its frontier to the same graph; the
    parked links equal the out-of-core ones; the bucketed materializer's
    strings equal the device materializer's as a set."""
    k, m = ECOLI["k"], ECOLI["m"]
    ds = scale_dataset(device)
    nb = ds.n_batches
    out = dict(preset=SCALE_CHECK_PRESET, n_batches=nb, window_slots=ds.total_slots)
    plain, k1, healed, t = counted(lambda: outofcore.partitioned_count(
        ds.keys, nb, partitions=4, cutoff=1))
    out["plain"] = dict(seconds=t, passes=plain.passes, k1=k1, reextracted=healed,
                        k1_expected=1 + plain.passes * nb + healed_scans(healed),
                        n_kept=plain.n_kept, n_distinct=plain.n_distinct)
    sup, k1, healed, t = counted(lambda: outofcore.partitioned_count_super(
        ds.super_records, nb, k=k, m=m, cutoff=1))
    out["super"] = dict(seconds=t, partitions=sup.partitions, group_size=sup.group_size,
                        passes=sup.passes, expand_chunks=sup.expand_chunks, k1=k1,
                        k1_expected=super_k1(sup, nb, healed), reextracted=healed)
    plain_sorted = torch.sort(plain.kmer).values
    checks = dict(
        super_equals_plain=bool(torch.equal(torch.sort(sup.kmer).values, plain_sorted))
        and (sup.n_kept, sup.n_distinct) == (plain.n_kept, plain.n_distinct),
        launches_as_planned=out["plain"]["k1"] == out["plain"]["k1_expected"]
        and out["super"]["k1"] == out["super"]["k1_expected"],
        out_of_core=plain.passes >= 1 and sup.partitions > 1)
    # the card's super count equals the CPU's on the first batches, in order
    cpu_ds = scale_dataset("cpu")
    kw = dict(k=k, m=m, partitions=3, cutoff=1)
    first = 2
    card = outofcore.partitioned_count_super(ds.super_records, first, **kw)
    t0 = time.perf_counter()
    cpu = outofcore.partitioned_count_super(cpu_ds.super_records, first, **kw)
    out["card_vs_cpu"] = dict(batches=first, n_kept=card.n_kept, cpu_seconds=time.perf_counter() - t0)
    checks["card_equals_cpu"] = bool(torch.equal(card.kmer.cpu(), cpu.kmer)) and all(
        torch.equal(a.cpu(), b) for a, b in zip(ds.super_records(0), cpu_ds.super_records(0)))
    del card, cpu, cpu_ds
    # a subrange count forced by a smaller SUB_COUNT_SLOTS
    real_slots = outofcore.SUB_COUNT_SLOTS
    outofcore.SUB_COUNT_SLOTS = FORCED_SUB_COUNT_SLOTS
    try:
        forced, k1, healed, t = counted(lambda: outofcore.partitioned_count_super(
            ds.super_records, nb, k=k, m=m, cutoff=1))
    finally:
        outofcore.SUB_COUNT_SLOTS = real_slots
    out["forced_subranges"] = dict(sub_count_slots=FORCED_SUB_COUNT_SLOTS, seconds=t,
                                   expand_chunks=forced.expand_chunks, k1=k1,
                                   k1_expected=super_k1(forced, nb, healed))
    checks["forced_subranges_equal"] = bool(torch.equal(torch.sort(forced.kmer).values,
                                                        plain_sorted)) and \
        (forced.n_kept, forced.n_distinct) == (sup.n_kept, sup.n_distinct) and \
        forced.expand_chunks > sup.expand_chunks and k1 == out["forced_subranges"]["k1_expected"]
    del forced, sup
    # two worker ranges, then a merge with no re-scan
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ck_") as ck:
        for rng_ in ((0, 2), (2, 4)):
            outofcore.partitioned_count(ds.keys, nb, partitions=4, cutoff=1, checkpoint_dir=ck,
                                        only_partitions=rng_, dataset_tag=ds.tag)
        merged, k1, _, t = counted(lambda: outofcore.partitioned_count(
            ds.keys, nb, partitions=4, cutoff=1, checkpoint_dir=ck, dataset_tag=ds.tag))
    out["worker_merge"] = dict(k1=k1, passes=merged.passes, seconds=t)
    checks["worker_merge_equals_fresh"] = bool(torch.equal(merged.kmer, plain.kmer)) and \
        k1 == 1 and merged.passes == 0
    del merged
    # a jump killed after 5 rounds, resumed from its frontier
    kmer, valid = plain.kmer, plain.valid
    links = dbg.build_unitig_links_join(kmer, valid, k=k)
    whole_rounds = []
    whole, t_whole, _ = timed_call(lambda: dbg.pointer_jump_bulk(
        links, on_round=lambda r, dt: whole_rounds.append(r)))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_jump_") as jd:
        seen = []

        def kill(r, dt):
            seen.append(r)
            if len(seen) == 5:
                raise _Killed
        try:
            dbg.pointer_jump_bulk(links, checkpoint_dir=jd, checkpoint_every=2, on_round=kill)
        except _Killed:
            pass
        saved = checkpoint_io.load_jump_frontier(jd, 2, checkpoint_io.jump_fingerprint(links))
        rounds = []
        resumed = dbg.pointer_jump_bulk(links, checkpoint_dir=jd, checkpoint_every=2,
                                        on_round=lambda r, dt: rounds.append(r))
    out["jump_resume"] = dict(states=int(links.shape[0]), killed_after_rounds=len(seen),
                              saved_round=None if saved is None else saved[2],
                              resumed_at=rounds[0] if rounds else None,
                              rounds_whole=len(whole_rounds), seconds_whole=t_whole)
    checks["jump_resume_equal"] = saved is not None and rounds[0] == saved[2] == 4 and all(
        torch.equal(a, b) for a, b in zip(whole, resumed))
    del resumed
    # the parked links (keys and links on the host) against the out-of-core ones
    parked, t_parked, parked_peak = timed_call(lambda: dbg.build_unitig_links_parked(
        kmer.cpu().numpy(), valid.cpu().numpy(), k=k, partitions=4, chunk_nodes=1 << 20,
        park_links=True, device=device))
    ooc, t_ooc, ooc_peak = timed_call(lambda: dbg.build_unitig_links_ooc(
        kmer, valid, k=k, partitions=4, chunk_nodes=1 << 20))
    out["links"] = dict(parked_seconds=t_parked, parked_peak=parked_peak, ooc_seconds=t_ooc,
                        ooc_peak=ooc_peak)
    checks["parked_links_equal"] = bool(torch.equal(torch.from_numpy(parked), ooc.cpu())) and \
        bool(torch.equal(ooc, links))
    del parked, ooc
    # the bucketed host materializer against the device one, as sets
    t0 = time.perf_counter()
    bucketed = dbg.materialize_unitigs_partitioned(kmer, valid, whole, k)
    t_bucketed = time.perf_counter() - t0
    on_card, t_card, _ = timed_call(lambda: dbg.materialize_unitigs_device(kmer, valid, whole, k)[0])
    out["materialize"] = dict(unitigs=len(bucketed), bucketed_host_seconds=t_bucketed,
                              device_seconds=t_card)
    checks["materialize_partitioned_equal"] = sorted(bucketed) == sorted(on_card) and \
        len(bucketed) > 0
    del links, whole, kmer, valid, plain
    torch.cuda.empty_cache()
    emit("scale_checks", **out, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"scale_checks failed: {checks}")


@contextlib.contextmanager
def timed_calls(module, name):
    """Yields a list that gets the seconds of each call of module.name made
    while the block runs (the card synchronised at both ends of a call)."""
    real = getattr(module, name)
    seconds = []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out
    setattr(module, name, timed)
    try:
        yield seconds
    finally:
        setattr(module, name, real)


def chr1_batch_steps(device):
    """Milliseconds of each step of one chr1 batch (131072 x 128), CUDA
    events: making the reads, K1 alone, the super-k-mer records (K1
    included), the extraction of a 16-partition group at the run's cap."""
    ds = scale_dataset(device, "chr1")
    codes, lengths = ds.codes(3)
    recs = ds.super_records(3)
    pids = torch.arange(16, device=device) * 6
    k, m = ECOLI["k"], ECOLI["m"]
    return dict(
        reads_ms=timed_ms(lambda: ds.codes(3)),
        fast_scan_ms=timed_ms(lambda: minimizer.fast_scan(codes, lengths, k=k, m=m)),
        super_records_ms=timed_ms(lambda: superkmer.super_records(codes, lengths, k=k, m=m)),
        extract_16_ms=timed_ms(lambda: outofcore.extract_partition_range_super(
            *recs, pids, partitions=105, cap_bp=12288)))


class HostPeak:
    """The largest resident set of this process while the block runs,
    sampled from /proc/self/statm every 0.2 s."""

    def __enter__(self):
        self.peak, self._stop = 0, threading.Event()
        page = os.sysconf("SC_PAGE_SIZE")

        def sample():
            while True:
                with open("/proc/self/statm") as f:
                    self.peak = max(self.peak, int(f.read().split()[1]) * page)
                if self._stop.wait(0.2):
                    return
        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def phase_scale_chr1(device):
    """The runner's chr1 rehearsal at full size, in process: 250 Mb x 30x,
    573 batches of 131072 x 128 = 7,360,217,088 window slots, super-k-mer
    staging, keys and links parked on the host, checkpoints in a temporary
    directory, the strings materialized.  Checks the invariants
    tests/test_scale_runner.py pins (no cycles, one string a linear unitig,
    total_bp = kept + unitigs x (k - 1), longest_bp = longest_chain + (k - 1),
    distinct <= G - k + 1) and that K1 launched 1 (the probe) + passes x 573
    + the batches a self-heal made again + the expansion chunks."""
    steps = chr1_batch_steps(device)
    torch.cuda.empty_cache()
    events = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chr1_") as ck, HostPeak() as host, \
            timed_calls(outofcore._PartStore, "save") as part_saves:
        rc, k1, healed, wall = counted(lambda: run_scale.main(
            SCALE_CHR1_ARGS + ["--checkpoint-dir", ck], emit_event=events.append))
        disk = sum(p.stat().st_size for p in pathlib.Path(ck).rglob("*") if p.is_file())
    launches = read_launch_counts()
    torch.cuda.empty_cache()
    ev = {e["event"]: e for e in events}
    cfg, sc, ext, mat = ev["config"], ev["scan_and_count"], ev["extension"], ev["materialize"]
    k = cfg["k"]
    want_k1 = 1 + sc["passes"] * cfg["n_batches"] + healed_scans(healed) + sc["expand_chunks"]
    checks = dict(
        exit_code=rc == 0, full_size=cfg["total_window_slots"] == CHR1_SLOTS,
        cyclic_states=ext["cyclic_states"] == 0,
        unitigs=mat["unitigs"] == ext["linear_unitigs"] > 0,
        total_bp=mat["total_bp"] == sc["kept"] + mat["unitigs"] * (k - 1),
        longest_bp=mat["longest_bp"] == ext["longest_chain"] + (k - 1),
        distinct=sc["kept"] <= sc["distinct"] <= cfg["genome_len"] - k + 1,
        k1_launches=k1 == want_k1,
        no_sort_kernel=not any(sort_kernel_launches(launches).values()),
        links_budget_emitted="links_budget" in ev)
    jump_rounds = [e for e in events if e["event"] == "jump_round"]
    link_passes = [e for e in events if e["event"] == "link_pass"]
    # the link staging cap and the (chunk, partition) shares that passed it
    link_over = [c for e in link_passes for c in e["overflowed_chunks"]]
    healed_links = [e["p"] for e in events if e["event"] == "link_reextract"]
    budget = ev.get("links_budget", {})
    checks["links_budget_plan_equals_link_passes"] = (
        budget.get("n_passes") == len(link_passes)
        and all(e["chunks"] == budget.get("n_chunks") for e in link_passes))
    link_staging = dict(cap_bp=link_passes[0]["cap_bp"], chunks=link_passes[0]["chunks"],
                        overflowed_chunk_partitions=sum(link_over),
                        partitions_overflowed=sum(c > 0 for c in link_over),
                        reextracted=healed_links)
    emit("scale_chr1", args=SCALE_CHR1_ARGS, wall_seconds=wall,
         phase_seconds={name: ev[name]["wall_s"] for name in (
             "scan_and_count", "links", "links_upload", "extension", "materialize")},
         peak_device_bytes={name: ev[name].get("peak_device_bytes") for name in (
             "scan_and_count", "links", "extension", "materialize")},
         peak_host_bytes=host.peak, checkpoint_bytes=disk,
         count={f: sc[f] for f in ("distinct", "kept", "partitions", "group_size", "passes",
                                   "expand_chunks")},
         reextracted=healed, k1_launches=k1, k1_expected=want_k1,
         batch_steps_ms=steps, part_saves=len(part_saves),
         part_save_seconds=sum(part_saves), link_staging=link_staging,
         link_partitions=ev["links_parked"]["partitions"], link_passes=len(link_passes),
         links_budget=budget,
         links_model_vs_measured=dict(model_t_total_s=budget.get("t_total_s"),
                                      measured_links_s=ev["links"]["wall_s"],
                                      measured_self_heal_partitions=len(healed_links)),
         link_pass_seconds=[e["wall_s"] for e in link_passes],
         jump_rounds=len(jump_rounds), jump_round_seconds=sum(e["wall_s"] for e in jump_rounds),
         extension={f: ext[f] for f in ("linear_unitigs", "cyclic_states", "longest_chain")},
         materialize={f: mat[f] for f in ("unitigs", "total_bp", "longest_bp")},
         config=cfg, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"scale_chr1 failed: {checks}")
    return k1


def phase_parity_ooc_golden(device):
    """The goldens' input out of core on the card (the JAX tests' 20,000 and
    50,000 bytes, and 20,000 over three batches of 7): both engines, lines
    and verbose, byte for byte; the pruned table equal to its golden."""
    reads = reads_io.load_reads_parity(str(GOLDEN / "input.txt"))
    unitigs = (GOLDEN / "input_k6m3_unitigs.txt").read_text()
    verbose = (GOLDEN / "input_k6m3_verbose.txt").read_text()
    post = {}
    for line in (GOLDEN / "input_k6m3_postprune.txt").read_text().splitlines():
        if line:
            mmer, kmer, ids = line.split("\t")
            post[(mmer, kmer)] = [int(x) for x in ids.split(",")] if ids else []
    reset_launch_counts()
    runs = []
    for batch_reads, limit in ((64, 20_000), (64, 50_000), (7, 20_000)):
        asm = ParityAssembler(PipelineConfig(k=6, m=3, batch_reads=batch_reads,
                                             outofcore_bytes=limit), device=device)
        if not asm._needs_outofcore(reads):
            raise AssertionError(f"parity_ooc_golden: {batch_reads}, {limit} stays in core")
        for engine in ("python", "native"):
            lines, stats = asm.assemble(reads, engine=engine)
            text, _ = asm.assemble(reads, engine=engine, verbose=True)
            got = ("\n".join(lines) + "\n" == unitigs, text == verbose,
                   (stats.entries_pre_prune, stats.entries_post_extension) == (97, 61))
            runs.append(dict(batch_reads=batch_reads, outofcore_bytes=limit, engine=engine,
                             unitigs_exact=got[0], verbose_exact=got[1],
                             counts_97_61=got[2], phase_seconds=dict(stats.wall_s)))
            if not all(got):
                raise AssertionError(f"parity_ooc_golden: {runs[-1]}")
        if asm.pruned_table_dict(reads) != post:
            raise AssertionError("parity_ooc_golden: pruned_table_dict differs from the golden")
    no_kernel_launched("parity_ooc_golden")
    emit("parity_ooc_golden", reads=len(reads), runs=runs, postprune_exact=True)


def by_first_seen(host, streams=None):
    """A HostTable (and its streams) with the groups in first-seen order,
    the order the replay sorts them into: the out-of-core table comes in
    it, the in-core one in (mmer, kmer) order."""
    order = np.argsort(host.first_seen, kind="stable")
    table = parity_table.HostTable(
        *(lane[order] for lane in host[:4]), read_ids=[host.read_ids[i] for i in order])
    return table if streams is None else (table, [streams[i] for i in order])


def phase_parity_ooc_scale(device):
    """Parity mode out of core at the default limits: a 2 Mb genome at 50x
    (2,000,000 read ids, 31 batches, 4 partitions); the unpruned host table
    equal to the in-core table of the same reads (outofcore_bytes 8 GiB),
    array for array.  Then BASELINE.md's big run forced out of core at
    150 MB (below the dirty form's 192.7 MB at 20 B a slot: at 200 MB it
    would stay in core), clean and with run_parity_soak.py --dirty's
    corruption: host
    tables, streams and string groups equal to in-core.  No replay (its cost
    grows as the square of the entries; its input is what is held equal
    here), no kernel launch."""
    p = PARITY_OOC_SCALE
    t0 = time.perf_counter()
    _, lines, _ = datagen.generate_coverage_reads(
        genome_len=p["genome_len"], read_len=p["read_len"], coverage=p["coverage"],
        seed=p["seed"])
    ids = fgets_read_ids(lines)
    t_reads = time.perf_counter() - t0
    cfg = parity_config(p)
    asm = ParityAssembler(cfg, device=device)
    n_batches = -(-len(ids) // cfg.batch_reads)
    slots = n_batches * cfg.batch_reads * cfg.windows_per_read
    if not asm._needs_outofcore(ids):
        raise AssertionError(f"parity_ooc_scale: {slots} slots stay in core")
    partitions = int(np.ceil(slots * 20 / (cfg.outofcore_bytes / 3)))
    reset_launch_counts()
    (host, stats), t_ooc, peak = timed_call(lambda: asm._groups_outofcore(ids, -1))
    torch.cuda.empty_cache()
    incore = ParityAssembler(dataclasses.replace(cfg, outofcore_bytes=INCORE_BYTES),
                             device=device)

    def incore_table():
        counted, in_stats = incore.counter.count_reads(ids)
        return parity_table.extract_groups(counted, pruned=False), in_stats

    (in_table, in_stats), t_in, in_peak = timed_call(incore_table)
    torch.cuda.empty_cache()
    same = dict(host_table=host_tables_equal(host, by_first_seen(in_table)),
                n_windows=stats.n_windows == in_stats.n_windows,
                entries=stats.entries_pre_prune == in_stats.entries_pre_prune == len(host.mmer))
    del in_table
    # BASELINE.md's big run, clean and dirty, forced out of core at 150 MB
    # (BIG_RUN_OOC_BYTES: the dirty form holds 192.7 MB at 20 B a slot)
    b = PARITY_E2E
    _, big_lines, _ = datagen.generate_coverage_reads(
        genome_len=b["genome_len"], read_len=b["read_len"], coverage=b["coverage"],
        seed=b["seed"])
    big_ids = fgets_read_ids(big_lines)
    dirty_ids = fgets_read_ids(dirtify(big_lines, b["seed"])[0])
    big_cfg = parity_config(b)
    forced = ParityAssembler(dataclasses.replace(big_cfg, outofcore_bytes=BIG_RUN_OOC_BYTES),
                             device=device)
    big_in = ParityAssembler(big_cfg, device=device)
    if not (forced._needs_outofcore(big_ids) and forced._needs_outofcore(dirty_ids)) \
            or big_in._needs_outofcore(big_ids):
        raise AssertionError("parity_ooc_scale: the forced limit does not split the big run")
    (ooc_clean, _), t_clean, clean_peak = timed_call(lambda: forced._groups_outofcore(big_ids, -1))
    same["big_clean_host_table"] = host_tables_equal(
        ooc_clean, by_first_seen(unpruned_host_table(big_in, big_ids)))
    ooc_host, ooc_streams, _ = forced._groups_outofcore(dirty_ids, -1, with_streams=True)
    counted, _ = big_in.counter.count_reads(dirty_ids)
    in_host, in_streams = by_first_seen(
        *parity_table.extract_groups_with_streams(counted, pruned=False))
    del counted
    same["big_dirty_host_table"] = host_tables_equal(ooc_host, in_host)
    same["big_dirty_streams"] = len(ooc_streams) == len(in_streams) and np.array_equal(
        np.concatenate(ooc_streams), np.concatenate(in_streams))
    (ooc_groups, ooc_gstats), t_dirty, dirty_peak = timed_call(
        lambda: forced._nonacgt_groups(dirty_ids))
    in_groups, in_gstats = big_in._nonacgt_groups(dirty_ids)
    same["big_dirty_string_groups"] = ooc_groups == in_groups
    no_kernel_launched("parity_ooc_scale")
    torch.cuda.empty_cache()
    emit("parity_ooc_scale", genome_len=p["genome_len"], coverage=p["coverage"],
         lines=len(lines), read_ids=len(ids), k=cfg.k, m=cfg.m, batch_reads=cfg.batch_reads,
         n_batches=n_batches, window_slots=slots, record_bytes_at_20_per_slot=slots * 20,
         outofcore_bytes=cfg.outofcore_bytes, partitions=partitions,
         read_generation_host_seconds=t_reads, phase_seconds=dict(stats.wall_s),
         outofcore_seconds=t_ooc, max_memory_allocated=peak,
         incore_phase_seconds=dict(in_stats.wall_s), incore_count_extract_seconds=t_in,
         incore_max_memory_allocated=in_peak, groups=len(host.mmer),
         peak_bytes_per_window_slot=peak / slots, incore_peak_bytes_per_window_slot=in_peak / slots,
         big_run=dict(read_ids=len(big_ids), dirty_read_ids=len(dirty_ids),
                      outofcore_bytes=BIG_RUN_OOC_BYTES, clean_seconds=t_clean,
                      clean_max_memory_allocated=clean_peak, dirty_groups_seconds=t_dirty,
                      dirty_max_memory_allocated=dirty_peak, string_groups=len(ooc_groups),
                      dirty_phase_seconds=dict(ooc_gstats.wall_s),
                      incore_dirty_phase_seconds=dict(in_gstats.wall_s)),
         replay="not run: the input it would replay is held equal to in core",
         equal_to_incore=same, **counters(stats))
    if not all(same.values()):
        raise AssertionError(f"parity_ooc_scale: out of core and in core differ: {same}")


def phase_sort_entry_points(device, n_keys):
    """K2 and K3a are on no pipeline's path: their entry points are
    ``sort_rows`` and ``sort_keys`` themselves.  Drive both once at a real
    size, counts set to 0 just before and read just after: ``sort_keys`` must
    go through the merge-sort kernel once."""
    gen = torch.Generator(device=device)
    gen.manual_seed(99)
    rows = random_keys(gen, ROWS_SHAPE[0] * ROWS_SHAPE[1], device, 0.3).view(ROWS_SHAPE)
    flat = random_keys(gen, n_keys, device, 0.3)
    chunk = bitonic_sort.DEFAULT_CHUNK
    reset_launch_counts()
    sorted_rows = bitonic_sort.sort_rows(rows)
    sorted_flat = bitonic_sort.sort_keys(flat)
    torch.cuda.synchronize()
    launches = read_launch_counts()
    t = Tally()
    t.hold(sorted_rows, torch.sort(rows, dim=1).values)
    t.hold(sorted_flat, torch.sort(flat).values)
    del sorted_rows, sorted_flat, rows
    # sort_keys is the hybrid's network from one chunk up
    want_big, want_finish = hybrid_pass_counts(n_keys, chunk, chunk)
    want = dict.fromkeys(read_launch_counts(), 0)
    want.update(sort_rows=1, chunk_sort=1, big_ce=want_big, finish=want_finish)
    if launches != want:
        raise AssertionError(f"sort_entry_points: launches {launches}, the sizes give {want}")
    emit("sort_entry_points", rows_shape=list(ROWS_SHAPE), sort_keys_n=n_keys, chunk=chunk,
         launches=launches, expected_launches=want, **t.report())
    if t.mismatches:
        raise AssertionError(f"sort_entry_points: {t.mismatches} mismatches")
    return launches


def mergepath_pass_counts(n, base_run, chunk):
    """(local_merge, merge_pass, merge_splits launches) of sort_keys_mergepath
    on n keys, from the sizes alone: the array pads to a power of two; one
    local pass unless the row sorts already fill the chunk; one split search
    and one merge pass per level chunk, 2 chunk .. total / 2."""
    if n < 4 * chunk:
        return 0, 0, 0
    levels = (n - 1).bit_length() - (chunk.bit_length() - 1)
    return int(base_run != chunk), levels, levels


def phase_mergepath_entry_point(device, n_keys, real_keys):
    """K4a, K4b and the split kernel are on no pipeline's path either: their
    entry point is ``sort_keys_mergepath``.  Drive it with its defaults at the main path's key
    count, once on random keys with 30 % sentinels and once on the ecoli read
    set's own scanned keys (real duplicates at 50x coverage, the sentinel
    share the reads give); counts set to 0 just before each call and read
    just after."""
    gen = torch.Generator(device=device)
    gen.manual_seed(77)
    if real_keys.shape[0] != n_keys:
        raise AssertionError(f"{real_keys.shape[0]} scanned keys for {n_keys} window slots")
    tile, base_run, chunk = (mergepath_sort.DEFAULT_MERGE_TILE, mergepath_sort.DEFAULT_BASE_RUN,
                             mergepath_sort.DEFAULT_MERGE_CHUNK)
    want_local, want_passes, want_splits = mergepath_pass_counts(n_keys, base_run, chunk)
    want = dict.fromkeys(read_launch_counts(), 0)
    want.update(local_merge=want_local, merge_pass=want_passes, merge_splits=want_splits)
    t = Tally()
    runs = {}
    for name, key in (("random", random_keys(gen, n_keys, device, 0.3)), ("real", real_keys)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        reset_launch_counts()
        got = mergepath_sort.sort_keys_mergepath(key)
        torch.cuda.synchronize()
        launches = read_launch_counts()
        peak = torch.cuda.max_memory_allocated()
        t.hold(got, torch.sort(key).values)
        runs[name] = {"launches": launches, "max_memory_allocated": peak,
                      "allocated_before_the_call": resident,
                      "sentinel_share": float((key == SENTINEL).double().mean()),
                      "distinct_keys": int(torch.unique_consecutive(got).shape[0])}
        del got
        if launches != want:
            raise AssertionError(f"mergepath_entry_point ({name} keys): launches {launches}, "
                                 f"the sizes give {want}")
    emit("mergepath_entry_point", n_keys=n_keys, tile=tile, base_run=base_run, chunk=chunk,
         expected_launches=want, runs=runs, **t.report())
    if t.mismatches or not (want_local and want_passes):
        raise AssertionError(f"mergepath_entry_point: {t.mismatches} mismatches, "
                             f"expected launches {want}")
    return runs["real"]["launches"]


# --------------------------------------------------------------------------
# parity mode: no kernel of csrc/ is on its path (the JAX package has no
# Pallas kernel there either); the phases hold the card against the
# goldens and against the port's own CPU path
# --------------------------------------------------------------------------

def parity_config(p, batch_reads=None):
    return PipelineConfig(k=p["k"], m=p["m"], abundance_cutoff=p["cutoff"],
                          max_read_len=p["max_read_len"],
                          batch_reads=batch_reads or p["batch_reads"])


def fgets_read_ids(lines):
    """The read ids the reference's loop makes of these lines: written to
    a file and read back through the fgets(101) emulation (a 100-bp line
    is a 99-bp read and an empty one)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "reads.txt"
        datagen.write_reads(lines, str(path))
        return reads_io.load_reads_parity(str(path))


def dirtify(reads, seed):
    """tools/run_parity_soak.py's corruption, kept here: ~5% of lines become
    200-bp joins of read pairs (fgets splits them); ~1% of the result gets
    a non-ACGT byte (N, a lowercase base, a lowercase run or a stray 'X')."""
    rng = np.random.default_rng(seed)
    lines = []
    i = 0
    while i < len(reads):
        if rng.random() < 0.05 and i + 1 < len(reads):
            lines.append(reads[i] + reads[i + 1])
            i += 2
        else:
            lines.append(reads[i])
            i += 1
    n_dirty = 0
    for j in range(len(lines)):
        if rng.random() >= 0.01:
            continue
        ln, pos = lines[j], int(rng.integers(0, len(lines[j])))
        kind = int(rng.integers(0, 4))
        if kind == 0:
            ln = ln[:pos] + "N" + ln[pos + 1:]
        elif kind == 1:
            ln = ln[:pos] + ln[pos].lower() + ln[pos + 1:]
        elif kind == 2:
            end = min(len(ln), pos + 10)
            ln = ln[:pos] + ln[pos:end].lower() + ln[end:]
        else:
            ln = ln[:pos] + "X" + ln[pos + 1:]
        lines[j] = ln
        n_dirty += 1
    return lines, n_dirty


def no_kernel_launched(phase):
    launches = read_launch_counts()
    if any(launches.values()):
        raise AssertionError(f"{phase}: the parity path launched a kernel: {launches}")


def timed_assemble(asm, reads, **kw):
    """One assemble() call on the card with the peak memory and the launch
    counts set to 0 just before it; (output, stats, wall seconds, peak)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    out, stats = asm.assemble(reads, **kw)
    torch.cuda.synchronize()
    return out, stats, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def phase_parity_golden(device):
    """The rebuilt input of the input_k6m3 goldens through the card, both
    engines, one batch and several: byte-exact goldens, 97 / 89 / 61."""
    reads = reads_io.load_reads_parity(str(GOLDEN / "input.txt"))
    unitigs = (GOLDEN / "input_k6m3_unitigs.txt").read_text()
    verbose = (GOLDEN / "input_k6m3_verbose.txt").read_text()
    post = {}
    for line in (GOLDEN / "input_k6m3_postprune.txt").read_text().splitlines():
        if line:
            mmer, kmer, ids = line.split("\t")
            post[(mmer, kmer)] = [int(x) for x in ids.split(",")] if ids else []
    reset_launch_counts()
    runs = []
    for batch_reads in (None, 7):
        cfg = PipelineConfig(k=6, m=3) if batch_reads is None else PipelineConfig(
            k=6, m=3, batch_reads=batch_reads)
        asm = ParityAssembler(cfg, device=device)
        for engine in ("python", "native"):
            lines, stats = asm.assemble(reads, engine=engine)
            text, _ = asm.assemble(reads, engine=engine, verbose=True)
            got = ("\n".join(lines) + "\n" == unitigs, text == verbose,
                   (stats.entries_pre_prune, stats.entries_post_prune,
                    stats.entries_post_extension) == (97, 89, 61))
            runs.append(dict(batch_reads=cfg.batch_reads, engine=engine,
                             unitigs_exact=got[0], verbose_exact=got[1], counts_97_89_61=got[2]))
            if not all(got):
                raise AssertionError(f"parity_golden: {runs[-1]}")
        table = asm.pruned_table_dict(reads)
        if table != post:
            raise AssertionError("parity_golden: pruned_table_dict differs from the golden")
    no_kernel_launched("parity_golden")
    emit("parity_golden", reads=len(reads), runs=runs, postprune_exact=True)


def host_tables_equal(a, b):
    """Two HostTables, lane for lane and group for group."""
    return (all(np.array_equal(x, y) for x, y in zip(a[:4], b[:4]))
            and len(a.read_ids) == len(b.read_ids)
            and np.array_equal(np.concatenate(a.read_ids), np.concatenate(b.read_ids)))


def unpruned_host_table(asm, ids):
    counted, _ = asm.counter.count_reads(ids)
    return parity_table.extract_groups(counted, pruned=False)


def phase_parity_e2e_and_dirty(device):
    """BASELINE.md's big run (``parity_e2e``) and the same reads with
    tools/run_parity_soak.py --dirty's corruption, in core (``parity_dirty``:
    the non-ACGT exception path regroups the card's streams).  The card's
    part of the path -- scan, count, merge and the read-back of the groups
    -- is held against the port's CPU path array for array: the unpruned
    host table of the clean reads, the regrouped string groups of the dirty
    ones.  The replay after it is host C++ and a function of those groups
    alone, so each read set is replayed once, through
    ``assemble(engine="native")`` on the card: as unitig lines, and the
    clean reads also as verbose text.  The clean line run is timed alone;
    the other runs go side by side (the replay, a C++ call, lets go of the
    GIL)."""
    p = PARITY_E2E
    t0 = time.perf_counter()
    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=p["genome_len"], read_len=p["read_len"], coverage=p["coverage"],
        seed=p["seed"])
    ids = fgets_read_ids(reads)
    dirty_lines, n_dirty = dirtify(reads, p["seed"])
    dirty_ids = fgets_read_ids(dirty_lines)
    t_reads = time.perf_counter() - t0
    cfg = parity_config(p)
    card, cpu = ParityAssembler(cfg, device=device), ParityAssembler(cfg, device="cpu")
    if card._needs_outofcore(dirty_ids):
        raise AssertionError("parity_dirty: the read set would go out of core")
    lines, stats, wall, peak = timed_assemble(card, ids, engine="native")
    no_kernel_launched("parity_e2e")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(6) as pool:
        runs = {
            "verbose": pool.submit(card.assemble, ids, engine="native", verbose=True),
            "dirty_lines": pool.submit(card.assemble, dirty_ids, engine="native"),
            "card_table": pool.submit(unpruned_host_table, card, ids),
            "cpu_table": pool.submit(unpruned_host_table, cpu, ids),
            "card_groups": pool.submit(card._nonacgt_groups, dirty_ids),
            "cpu_groups": pool.submit(cpu._nonacgt_groups, dirty_ids),
        }
        runs = {name: run.result() for name, run in runs.items()}
    t_side = time.perf_counter() - t0
    side_peak = torch.cuda.max_memory_allocated()
    no_kernel_launched("parity_dirty")
    text, _ = runs["verbose"]
    card_table, cpu_table = runs["card_table"], runs["cpu_table"]
    same = (host_tables_equal(card_table, cpu_table),
            len(card_table.mmer) == stats.entries_pre_prune)
    emit("parity_e2e", genome_len=p["genome_len"], coverage=p["coverage"], lines=len(reads),
         read_ids=len(ids), k=cfg.k, m=cfg.m, batch_reads=cfg.batch_reads,
         n_batches=-(-len(ids) // cfg.batch_reads), read_generation_host_seconds=t_reads,
         host_table_equal_cpu=same[0], groups_equal_entries_pre_prune=same[1],
         unitig_lines=len(lines), verbose_bytes=len(text), side_by_side_runs_seconds=t_side,
         phase_seconds=dict(stats.wall_s), assemble_wall_seconds=wall,
         max_memory_allocated=peak,
         records_per_s_scan_count=stats.n_windows
         / (stats.wall_s["scan"] + stats.wall_s["count"]), **counters(stats))
    if not all(same) or not lines or not text:
        raise AssertionError(f"parity_e2e: card and CPU differ {same}")
    # a corrupted window occurs once and is pruned, so raw bytes rarely
    # reach a unitig; what the exception path needs is dirty reads
    d_lines, d_stats = runs["dirty_lines"]
    (card_groups, card_stats), (cpu_groups, cpu_stats) = (
        runs["card_groups"], runs["cpu_groups"])
    n_dirty_ids = len(nonacgt.dirty_read_ids(dirty_ids))
    same = (card_groups == cpu_groups, counters(card_stats) == counters(cpu_stats),
            counters(d_stats) == dict(counters(card_stats), entries_post_extension=len(d_lines)))
    emit("parity_dirty", lines=len(dirty_lines), dirty_lines=n_dirty, read_ids=len(dirty_ids),
         dirty_read_ids=n_dirty_ids, longest_read=max(map(len, dirty_ids)),
         string_groups=len(card_groups), groups_equal_cpu=same[0],
         counters_equal_cpu=same[1], unitig_lines=len(d_lines),
         unitigs_with_raw_bytes=sum(not frozenset("ACGT").issuperset(u) for u in d_lines),
         ran_side_by_side=True, phase_seconds=dict(d_stats.wall_s),
         max_memory_allocated_side_by_side=side_peak, **counters(d_stats))
    if not all(same) or not n_dirty_ids or not d_lines:
        raise AssertionError(f"parity_dirty: card and CPU differ {same}, "
                             f"{n_dirty_ids} dirty reads")
    return dict(ids=ids, lines=lines, dirty_ids=dirty_ids, dirty_lines=d_lines)


def phase_parity_scale(device):
    """The largest in-core parity read set: count and extract on the card,
    the count's invariants held, the first batch's scan equal to the CPU's.
    The replay of this many entries is left out: it takes longer than this
    script's whole time limit (parity_replay_scaling.py times it)."""
    p = PARITY_SCALE
    t0 = time.perf_counter()
    _, reads, _ = datagen.generate_coverage_reads(
        genome_len=p["genome_len"], read_len=p["read_len"], coverage=p["coverage"],
        seed=p["seed"])
    ids = fgets_read_ids(reads)
    t_reads = time.perf_counter() - t0
    cfg = parity_config(p)
    asm = ParityAssembler(cfg, device=device)
    n_batches = -(-len(ids) // cfg.batch_reads)
    slots = n_batches * cfg.batch_reads * cfg.windows_per_read
    if asm._needs_outofcore(ids):
        raise AssertionError(f"parity_scale: {slots} slots would go out of core")
    host_windows = sum(max(0, len(r) - cfg.k + 1) for r in ids)
    # the first batch's scan on the card and on the CPU
    first = reads_io.batch_reads(ids[: cfg.batch_reads], cfg.max_read_len, parity_chars=True)[0]
    codes, lengths, _ = convert.read_batch_to_torch(first)
    on_card = minimizer.parity_scan(codes.to(device), lengths.to(device), k=cfg.k, m=cfg.m)
    on_cpu = minimizer.parity_scan(codes, lengths, k=cfg.k, m=cfg.m)
    scan_equal = all(torch.equal(a.cpu(), b) for a, b in zip(on_card, on_cpu))
    del on_card
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    counted, stats = asm.counter.count_reads(ids)
    clock_t = time.perf_counter()
    valid = counted.valid
    starts = counted.group_start & valid
    occurrences = int(counted.count[starts].sum())
    mm, km, stream = counted.mmer[valid], counted.kmer[valid], counted.stream_idx[valid]
    gs = counted.group_start[valid]
    same_key = (mm[1:] == mm[:-1]) & (km[1:] == km[:-1])
    ascending = (mm[1:] > mm[:-1]) | ((mm[1:] == mm[:-1]) & (km[1:] >= km[:-1]))
    head_mm, head_km = mm[gs], km[gs]
    strictly = (head_mm[1:] > head_mm[:-1]) | (
        (head_mm[1:] == head_mm[:-1]) & (head_km[1:] > head_km[:-1]))
    invariants = dict(
        ascending=bool(ascending.all()), group_heads_strictly_ascending=bool(strictly.all()),
        heads_where_keys_change=bool(torch.equal(gs[1:], ~same_key)),
        streams_ascending_in_groups=bool((stream[1:][same_key] > stream[:-1][same_key]).all()))
    del mm, km, stream, gs, same_key, ascending, head_mm, head_km, strictly
    t_check = time.perf_counter() - clock_t
    clock_t = time.perf_counter()
    host = parity_table.extract_groups(counted, pruned=False)
    del counted, valid, starts
    t_extract = time.perf_counter() - clock_t
    peak = torch.cuda.max_memory_allocated()
    no_kernel_launched("parity_scale")
    stats.wall_s["extract"] = t_extract
    ok = dict(scan_first_batch_equal_cpu=scan_equal,
              occurrences_equal_host_windows=occurrences == host_windows == stats.n_windows,
              groups_extracted=len(host.mmer) == stats.entries_pre_prune, **invariants)
    emit("parity_scale", genome_len=p["genome_len"], coverage=p["coverage"], lines=len(reads),
         read_ids=len(ids), k=cfg.k, m=cfg.m, batch_reads=cfg.batch_reads, n_batches=n_batches,
         window_slots=slots, record_bytes_at_20_per_slot=slots * 20,
         outofcore_bytes=cfg.outofcore_bytes, read_generation_host_seconds=t_reads,
         host_windows=host_windows, occurrences=occurrences, replay="not run: see parity_replay_scaling.py",
         check_seconds=t_check, checks=ok,
         phase_seconds=dict(stats.wall_s), max_memory_allocated=peak,
         records_per_s_scan_count=stats.n_windows
         / (stats.wall_s["scan"] + stats.wall_s["count"]), **counters(stats))
    if not all(ok.values()):
        raise AssertionError(f"parity_scale: {ok}")
    torch.cuda.empty_cache()


def timed_ms_runs(fn, reps=9, warm=2, calls=1, spin_cycles=0):
    """ms of one fn() in each of `reps` event pairs.  With `calls` > 1 each
    pair spans that many calls back to back.  With `spin_cycles`, a spin
    kernel of that many clock cycles holds the stream before each pair, so
    the host queues the calls ahead of the card and the events time the
    card's work alone, not the host's launch path."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if spin_cycles:
            torch.cuda._sleep(spin_cycles)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return times


def timed_ms(fn, reps=9, warm=2, calls=1):
    """Median ms of one fn() over `reps` event pairs.  With `calls` > 1 each
    pair spans that many calls back to back, so that a kernel shorter than
    its wrapper's host work is timed on the card and not on the host."""
    return statistics.median(timed_ms_runs(fn, reps=reps, warm=warm, calls=calls))


def turn_about(kernel, plain, *, kernel_reps=9, plain_reps=5, warm=2, kernel_calls=1):
    """Median times in the order plain, kernel, kernel, plain; the smaller
    of each pair is reported."""
    plain_a = timed_ms(plain, reps=plain_reps, warm=warm)
    kernel_a = timed_ms(kernel, reps=kernel_reps, warm=warm, calls=kernel_calls)
    kernel_b = timed_ms(kernel, reps=kernel_reps, warm=warm, calls=kernel_calls)
    plain_b = timed_ms(plain, reps=plain_reps, warm=warm)
    return {"ms": min(kernel_a, kernel_b), "plain_ms": min(plain_a, plain_b),
            "kernel_ms_runs": [kernel_a, kernel_b], "plain_ms_runs": [plain_a, plain_b]}


# 32-bit operations of one compare-exchange of two int64 keys: the 64-bit
# compare 2, the two 64-bit selects 4, the direction bit (and, compare) 2
CE_OPS = 8


# the same in the odd-even merge network, which has no direction bit
MERGE_CE_OPS = 6
# 32-bit operations of one step of a binary search in a merge window: the
# 64-bit compare 2, the two bounds' selects 2
SEARCH_STEP_OPS = 4


def pass_bound(n_keys, stages, ce_ops=CE_OPS):
    """(bytes ms, operations ms) of one pass over n_keys keys that runs
    `stages` stages: every key read once and written once, 16 bytes; every
    stage one compare-exchange per pair of keys."""
    return (16 * n_keys / PEAK_BYTES_PER_S * 1e3,
            stages * (n_keys // 2) * ce_ops / PEAK_ALU_OPS_PER_S * 1e3)


def merge_pass_bound(n_keys, tile, per_thread):
    """(bytes ms, operations ms) of one merge-path pass: 16 bytes a key (the
    split arrays, 16 bytes a tile, are left out); per output key one 64-bit
    compare and the selects of the key and of the head that moves on, 6, and
    its share of its thread's search, log2(tile) steps for per_thread keys."""
    per_key = MERGE_CE_OPS + SEARCH_STEP_OPS * (tile.bit_length() - 1) / per_thread
    return (16 * n_keys / PEAK_BYTES_PER_S * 1e3, n_keys * per_key / PEAK_ALU_OPS_PER_S * 1e3)


def local_merge_bound(n_keys, base_run, chunk, per_thread):
    """(bytes ms, operations ms) of one local_merge pass: 16 bytes a key; the
    odd-even levels a thread runs in registers (2 base_run .. per_thread), a
    compare-exchange per pair and stage, then per round run -> 2 run and key
    one merge step and its share of the thread's search of log2(2 run) steps."""
    ops = 0.0
    for level in merge_levels(base_run, min(per_thread, chunk)):
        ops += (level.bit_length() - 1) * (n_keys // 2) * MERGE_CE_OPS
    run = max(base_run, per_thread)
    while run < chunk:
        ops += n_keys * (MERGE_CE_OPS + SEARCH_STEP_OPS * run.bit_length() / per_thread)
        run *= 2
    return 16 * n_keys / PEAK_BYTES_PER_S * 1e3, ops / PEAK_ALU_OPS_PER_S * 1e3


def merge_splits_work(n_keys, run, tile):
    """(bytes ms, operations ms, longest chain) of one merge_splits launch: a
    tile on diagonal d searches min(d, run) - max(d - run, 0) + 1 candidates,
    ceil(log2) steps of two 8-byte loads; it writes four int64.  The longest
    chain of dependent steps is what the launch waits for."""
    d = torch.arange(0, 2 * run, tile, dtype=torch.int64)
    width = d.clamp(max=run) - (d - run).clamp(min=0)
    steps = torch.ceil(torch.log2((width + 1).double())).long()
    pairs = n_keys // (2 * run)
    total_steps = int(steps.sum()) * pairs
    n_tiles = n_keys // tile
    return ((16 * total_steps + 32 * n_tiles) / PEAK_BYTES_PER_S * 1e3,
            SEARCH_STEP_OPS * total_steps / PEAK_ALU_OPS_PER_S * 1e3, int(steps.max()))


def merge_levels(base_run, chunk):
    """The levels local_merge runs in sort_keys_mergepath: 2 base_run .. chunk."""
    return levels_up_to(chunk)[base_run.bit_length() - 1:]


def bound_fields(passes):
    """The bound of a run of passes: each pass takes the larger of its two
    times; `bound_by` names what bounds the larger part of the sum."""
    by_bytes = sum(b for b, o in passes if b >= o)
    by_ops = sum(o for b, o in passes if o > b)
    return {"bound_ms": by_bytes + by_ops,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_bytes_ms": sum(b for b, _ in passes),
            "bound_operations_ms": sum(o for _, o in passes)}


def scan_bound(codes, lengths, k, m):
    """bound_fields of K1 on one batch: each input read once, each output
    (mmer 4 B, kmer 8 B, valid 1 B per window slot) written once;
    operations the least the function needs for THIS batch, O(1) a window
    whatever k and m: a base packed into two bits (1); per m-mer position
    its 32 bits from two words and their reverse complement and the smaller
    one (12); one min per position and level of the log-step window minimum
    (log2(k - m + 1) levels); per window that exists its 64 bits, reverse
    complement, the smaller one and the window minimum (24)."""
    b_rows, max_len = codes.shape
    n_win, n_mpos = max_len - k + 1, max_len - m + 1
    n_valid = int((torch.arange(n_win, device=codes.device)[None, :] + k
                   <= lengths[:, None]).sum())
    levels = (k - m + 1).bit_length() - 1
    n_bytes = b_rows * max_len + 4 * b_rows + 13 * b_rows * n_win
    n_ops = b_rows * max_len + b_rows * n_mpos * (12 + levels) + n_valid * 24
    return bound_fields([(n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / PEAK_ALU_OPS_PER_S * 1e3)])


def time_scan(device, batch, launches, tally, chr1_launches, mesh_launches, mesh2_launches):
    """K1 and its plain version on one batch of the main path
    ([65536, 128], k=31, m=7, the reads of full_e2e), turn about; and at
    the super-k-mer count's expansion shape ([2^20, 55]: real record rows
    of the runner's ecoli reads), where scale_chr1 launches it most."""
    k, m = ECOLI["k"], ECOLI["m"]
    codes = torch.from_numpy(batch.codes).to(device)
    lengths = torch.from_numpy(batch.lengths).to(device)
    if tuple(codes.shape) != KERNEL_SHAPE:
        raise AssertionError(f"main-path batch is {tuple(codes.shape)}, not {KERNEL_SHAPE}")
    # 20 launches an event pair: the wrapper's host work (checks, three
    # allocations, the ctypes call) takes longer than the kernel
    times = turn_about(lambda: minimizer.fast_scan(codes, lengths, k=k, m=m),
                       lambda: minimizer.fast_scan_plain(codes, lengths, k=k, m=m),
                       kernel_calls=20)
    times["ms_one_call_an_event_pair"] = timed_ms(
        lambda: minimizer.fast_scan(codes, lengths, k=k, m=m))
    bound = scan_bound(codes, lengths, k, m)
    rows, row_lengths = expansion_rows(device, EXPAND_ROWS)
    at_expansion = turn_about(lambda: minimizer.fast_scan(rows, row_lengths, k=k, m=m),
                              lambda: minimizer.fast_scan_plain(rows, row_lengths, k=k, m=m))
    at_expansion.update(shape=list(rows.shape), **scan_bound(rows, row_lengths, k, m))
    del rows, row_lengths
    return {
        "name": "fast_scan", "route": "cuda",
        "source": "genome_assembly_tpu_torch/csrc/fast_scan.cu",
        "replaces": "genome_assembly_tpu/ops/minimizer_pallas.py:25",
        "launches": launches, "launches_from": "full_e2e (hybrid_e2e launches it as often)",
        "launches_by_path": {"full_e2e": launches, "scale_chr1": chr1_launches,
                             "mesh_e2e": mesh_launches, "mesh2_e2e": mesh2_launches},
        "max_abs_err": tally[1], "mismatches": tally[0],
        **times, "kernel_ms": times["ms"], **bound, "library_ms": None,
        "shape": list(KERNEL_SHAPE), "k": k, "m": m,
        "at_expansion_shape": at_expansion,
    }


def sort_entry(name, kernel_fn, replaces, launches, launches_from, tally, at_shape, times,
               bound, library_ms, shape,
               source="genome_assembly_tpu_torch/csrc/bitonic.cu", **more):
    """One line of the kernels report for a sort kernel or a composed sort."""
    return {
        "name": name, "route": "cuda", "source": source, "kernel": kernel_fn,
        "replaces": replaces, "launches": launches, "launches_from": launches_from,
        "max_abs_err": max(tally.max_abs_err, at_shape.max_abs_err),
        "mismatches": tally.mismatches + at_shape.mismatches,
        "cases": tally.cases + at_shape.cases,
        **times, **bound, "library_ms": library_ms, "shape": shape, **more,
    }


def time_sort_kernels(device, tallies, hybrid_launches, entry_launches, n_keys):
    """K2 at ROWS_SHAPE and at SQUARE_ROWS_SHAPE; K3a, K3b, K3c
    at the main path's padded key count (one pass each); the two composed
    sorts at the main path's key count.  Each kernel is also held against its
    plain version at the timed shape.  The bound of a sort is the least time
    for the function, whatever computes it: 16 bytes a key, or the operations
    of the merge sort where those take longer (`local_merge_bound`)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(2024)
    chunk, lib = bitonic_sort.DEFAULT_CHUNK, bitonic_sort.DEFAULT_LIB_CHUNK
    entries = []

    at = Tally()
    at_shape = {}
    per_thread = bitonic_cuda.KEYS_PER_THREAD
    for shape, plain_reps in ((ROWS_SHAPE, 3), (SQUARE_ROWS_SHAPE, 1)):
        rows = random_keys(gen, shape[0] * shape[1], device, 0.3).view(shape)
        at.hold(bitonic_sort.sort_rows(rows), bitonic_sort.sort_rows_plain(rows))
        block_keys, threads, shared_bytes = bitonic_cuda.block_shape(shape[1])
        at_shape[shape] = dict(
            shape=list(shape), block_keys=block_keys, keys_per_thread=per_thread, threads=threads,
            shared_bytes=shared_bytes,
            **turn_about(lambda: bitonic_sort.sort_rows(rows),
                         lambda: bitonic_sort.sort_rows_plain(rows), plain_reps=plain_reps, warm=1),
            **bound_fields([local_merge_bound(rows.numel(), 1, shape[1], per_thread)]),
            library_ms=timed_ms(lambda: torch.sort(rows, dim=1), reps=5))
        del rows
    main_shape = at_shape[ROWS_SHAPE]
    entries.append(sort_entry(
        "sort_rows", "sort_rows_kernel", "genome_assembly_tpu/ops/sort_pallas.py:56",
        entry_launches["sort_rows"], "sort_entry_points (no pipeline calls the row sort)",
        tallies["sort_rows"], at, {}, {}, main_shape["library_ms"], list(ROWS_SHAPE),
        library_call="torch.sort(x, dim=1)", **{k: v for k, v in main_shape.items()
                                                if k not in ("shape", "library_ms")},
        at_square_shape=at_shape[SQUARE_ROWS_SHAPE]))

    total = lib
    while total < n_keys:
        total *= 2
    key = random_keys(gen, total, device, 0.3)
    sizes = levels_up_to(chunk)
    log_chunk = chunk.bit_length() - 1
    block_keys, threads, shared_bytes = bitonic_cuda.block_shape(chunk)
    chunk_sort_bound = local_merge_bound(total, 1, chunk, per_thread)

    at = Tally()
    at.hold(bitonic_sort.chunk_sort(key, sizes, chunk=chunk),
            bitonic_sort.chunk_sort_plain(key, sizes, chunk=chunk))
    entries.append(sort_entry(
        "chunk_sort", "chunk_sort_kernel", "genome_assembly_tpu/ops/bitonic_pallas.py:70",
        entry_launches["chunk_sort"], "sort_entry_points (sort_keys; no pipeline calls it)",
        tallies["chunk_sort"], at,
        turn_about(lambda: bitonic_sort.chunk_sort(key, sizes, chunk=chunk),
                   lambda: bitonic_sort.chunk_sort_plain(key, sizes, chunk=chunk),
                   kernel_reps=5, plain_reps=2, warm=1),
        bound_fields([chunk_sort_bound]),
        timed_ms(lambda: torch.sort(key.view(-1, chunk), dim=1), reps=5, warm=1), [total],
        library_call="torch.sort(x.view(-1, chunk), dim=1): the ascending half of the "
                     "function (the kernel sorts every other chunk descending)",
        chunk=chunk, levels=len(sizes),
        block_keys=block_keys, keys_per_thread=per_thread, threads=threads,
        shared_bytes=shared_bytes))

    at = Tally()
    at.hold(bitonic_sort.big_ce(key, total // 2, total),
            bitonic_sort.big_ce_plain(key, total // 2, total))
    at.hold(bitonic_sort.big_ce(key, chunk, 2 * chunk),
            bitonic_sort.big_ce_plain(key, chunk, 2 * chunk))
    entries.append(sort_entry(
        "big_ce", "big_ce_kernel", "genome_assembly_tpu/ops/bitonic_pallas.py:88",
        hybrid_launches["big_ce"], "hybrid_e2e", tallies["big_ce"], at,
        turn_about(lambda: bitonic_sort.big_ce(key, total // 2, total),
                   lambda: bitonic_sort.big_ce_plain(key, total // 2, total)),
        bound_fields([pass_bound(total, 1)]), None, [total], d=total // 2, size=total,
        ms_at_smallest_d=timed_ms(lambda: bitonic_sort.big_ce(key, chunk, 2 * chunk)),
        ms_in_place=timed_ms(
            lambda: bitonic_sort.big_ce(key, total // 2, total, overwrite=True))))
    # (the in-place timing left `key` one stage on; it is random input still)

    at = Tally()
    at.hold(bitonic_sort.finish(key, total, chunk=chunk),
            bitonic_sort.finish_plain(key, total, chunk=chunk))
    times = turn_about(lambda: bitonic_sort.finish(key, total, chunk=chunk),
                       lambda: bitonic_sort.finish_plain(key, total, chunk=chunk), plain_reps=3)
    # what the sort gives finish at level == total: bitonic chunks, each of
    # which it sorts ascending; there one library call computes the same
    # function, the sort of every chunk (timed here, used nowhere in the port)
    bitonic = bitonic_chunks(key, chunk)
    library = torch.sort(bitonic.view(-1, chunk), dim=1).values.view(-1)
    at.hold(bitonic_sort.finish(bitonic, total, chunk=chunk), library)
    del library
    threads, per_thread, groups, shared_bytes = bitonic_cuda.finish_shape(chunk)
    entries.append(sort_entry(
        "finish", "finish_kernel", "genome_assembly_tpu/ops/bitonic_pallas.py:117",
        hybrid_launches["finish"], "hybrid_e2e", tallies["finish"], at, times,
        bound_fields([pass_bound(total, log_chunk)]),
        timed_ms(lambda: torch.sort(bitonic.view(-1, chunk), dim=1), reps=5, warm=1), [total],
        chunk=chunk, size=total, threads=threads, keys_per_thread=per_thread,
        stage_groups=len(groups), shared_exchanges=len(groups) - 1, shared_bytes=shared_bytes,
        library_call="torch.sort(x.view(-1, chunk), dim=1) on bitonic chunks",
        ms_bitonic_input=timed_ms(lambda: bitonic_sort.finish(bitonic, total, chunk=chunk)),
        ms_in_place=timed_ms(
            lambda: bitonic_sort.finish(key, total, chunk=chunk, overwrite=True))))
    del key, bitonic

    # the composed sorts, at the main path's key count
    flat = random_keys(gen, n_keys, device, 0.3)
    want = torch.sort(flat).values
    library_ms = timed_ms(lambda: torch.sort(flat), reps=3, warm=1)
    # the hybrid's own library part: the row-wise sort of its 2^21-key chunks
    padded = bitonic_sort._padded_copy(flat, lib)
    chunk_sorts_ms = timed_ms(lambda: torch.sort(padded.view(-1, lib), dim=1), reps=3, warm=1)
    del padded
    big_keys, fin_keys = hybrid_pass_counts(n_keys, chunk, chunk)
    big_hyb, fin_hyb = hybrid_pass_counts(n_keys, lib, chunk)
    one_big, one_fin = pass_bound(total, 1), pass_bound(total, log_chunk)
    plans = [
        ("sort_keys", bitonic_sort.sort_keys, "genome_assembly_tpu/ops/bitonic_pallas.py:217",
         sum(entry_launches[k] for k in ("chunk_sort", "big_ce", "finish")),
         "sort_entry_points (kernel launches of one sort_keys call)",
         [chunk_sort_bound] + [one_big] * big_keys + [one_fin] * fin_keys,
         lambda: plain_network(flat, chunk, chunk), {}),
        ("sort_keys_hybrid", bitonic_sort.sort_keys_hybrid,
         "genome_assembly_tpu/ops/bitonic_pallas.py:285",
         hybrid_launches["big_ce"] + hybrid_launches["finish"],
         "hybrid_e2e (kernel launches of its one sort_keys_hybrid call)",
         # the library sort of the chunks counts as one pass over the keys
         [pass_bound(total, 0)] + [one_big] * big_hyb + [one_fin] * fin_hyb,
         lambda: plain_network(flat, lib, chunk),
         {"lib_chunk": lib, "library_chunk_sorts_ms": chunk_sorts_ms}),
    ]
    for name, fn, replaces, launches, launches_from, passes, plain, more in plans:
        at = Tally()
        at.hold(fn(flat), want)
        at.hold(plain(), want)
        times = {"ms": timed_ms(lambda: fn(flat), reps=3, warm=1),
                 "plain_ms": timed_ms(plain, reps=1, warm=0)}
        entries.append(sort_entry(
            name, "chunk_sort_kernel, big_ce_kernel, finish_kernel", replaces,
            launches, launches_from, tallies[name], at, times,
            bound_fields(passes), library_ms, [n_keys],
            source="genome_assembly_tpu_torch/ops/bitonic_sort.py", composite=True,
            chunk=chunk, padded_to=total, passes=len(passes), library_call="torch.sort(x)",
            **more))
    return entries


def chunk_runs(padded, base_run):
    """What local_merge is given in sort_keys_mergepath: the padded keys as
    they are for base_run 1, else their rows of base_run sorted."""
    return padded if base_run == 1 else sorted_runs(padded, base_run)


def plain_mergepath(key, tile, base_run, chunk):
    """sort_keys_mergepath composed of the PLAIN passes, on the card."""
    n = key.shape[0]
    buf = chunk_runs(bitonic_sort._padded_copy(key, chunk), base_run)
    levels = merge_levels(base_run, chunk)
    if levels:
        buf = mergepath_sort.local_merge_plain(buf, levels, chunk=chunk)
    run = chunk
    while run < buf.shape[0]:
        buf = mergepath_sort.merge_pass_plain(
            buf, mergepath_sort.merge_splits_plain(buf, run, tile), run=run, tile=tile)
        run *= 2
    return buf[:n]


# runs local_merge merged in its first form: the shape its earlier time was taken at
EARLIER_BASE_RUN = 1 << 10


def time_merge_kernels(device, tallies, launches, n_keys, real_keys):
    """K4a, K4b and the split kernel at the main path's padded key count, one
    launch each on valid input (runs ascending): K4a from the default base_run
    and from runs of 2^10, K4b at its largest and its smallest run, the split
    search at every level; the composed sort at the main path's key count, on
    random and on real keys.  Each kernel is also held against its plain
    version at the timed shape."""
    gen = torch.Generator(device=device)
    gen.manual_seed(2025)
    tile, base_run, chunk = (mergepath_sort.DEFAULT_MERGE_TILE, mergepath_sort.DEFAULT_BASE_RUN,
                             mergepath_sort.DEFAULT_MERGE_CHUNK)
    per_thread = mergepath_cuda.KEYS_PER_THREAD
    local_per_thread = mergepath_cuda.LOCAL_KEYS_PER_THREAD
    source = "genome_assembly_tpu_torch/csrc/mergepath.cu"
    entry_point = "mergepath_entry_point (no pipeline calls the merge-path sort)"
    flat = random_keys(gen, n_keys, device, 0.3)
    padded = bitonic_sort._padded_copy(flat, chunk)
    total = padded.shape[0]
    entries = []

    row_sort_ms = (timed_ms(lambda: torch.sort(padded.view(-1, base_run), dim=1), reps=3, warm=1)
                   if base_run > 1 else 0.0)
    local = {}
    for base in sorted({base_run, EARLIER_BASE_RUN}):
        state = chunk_runs(padded, base)
        levels = merge_levels(base, chunk)
        at = Tally()
        at.hold(mergepath_sort.local_merge(state, levels, chunk=chunk),
                mergepath_sort.local_merge_plain(state, levels, chunk=chunk))
        times = turn_about(lambda: mergepath_sort.local_merge(state, levels, chunk=chunk),
                           lambda: mergepath_sort.local_merge_plain(state, levels, chunk=chunk),
                           kernel_reps=5, plain_reps=2, warm=1)
        # on valid input one library call computes the same function: the sort
        # of every chunk (timed here, used nowhere in the port)
        library_ms = timed_ms(lambda: torch.sort(state.view(-1, chunk), dim=1), reps=3, warm=1)
        local[base] = dict(at=at, times=times, library_ms=library_ms, levels=levels,
                           bound=local_merge_bound(total, base, chunk, local_per_thread))
    del padded
    main, other = local[base_run], local[EARLIER_BASE_RUN]
    entries.append(sort_entry(
        "local_merge", "local_merge_kernel", "genome_assembly_tpu/ops/mergepath_pallas.py:210",
        launches["local_merge"], entry_point, tallies["local_merge"], main["at"], main["times"],
        bound_fields([main["bound"]]), main["library_ms"], [total],
        source=source, chunk=chunk, base_run=base_run, keys_per_thread=local_per_thread,
        levels=len(main["levels"]), library_call="torch.sort(x.view(-1, chunk), dim=1)",
        input="the padded keys as they are" if base_run == 1 else "rows of base_run keys ascending",
        at_earlier_shape=dict(
            base_run=EARLIER_BASE_RUN, levels=len(other["levels"]), mismatches=other["at"].mismatches,
            library_ms=other["library_ms"], **other["times"], **bound_fields([other["bound"]]))))
    if other["at"].mismatches:
        raise AssertionError("local_merge differs from its plain version on runs of 2^10")

    # the sort's own state, level by level: the split search is timed at every
    # level beside its plain version, K4b is held and timed at the first (run
    # == chunk) and the last
    state = mergepath_sort.local_merge(state, local[max(local)]["levels"], chunk=chunk,
                                       overwrite=True)
    spare = torch.empty_like(state)
    at, at_splits = Tally(), Tally()
    splits_ms, splits_plain_ms, splits_work = [], [], []
    pass_ms, pass_times, pass_library_ms = [], {}, {}
    run = chunk
    while run < total:
        splits = mergepath_sort.merge_splits(state, run, tile)
        for ours, theirs in zip(splits, mergepath_sort.merge_splits_plain(state, run, tile)):
            at_splits.hold(ours, theirs)
        search = turn_about(lambda: mergepath_sort.merge_splits(state, run, tile),
                            lambda: mergepath_sort.merge_splits_plain(state, run, tile),
                            kernel_reps=9, plain_reps=2, warm=1)
        splits_ms.append(search["ms"])
        splits_plain_ms.append(search["plain_ms"])
        splits_work.append(merge_splits_work(total, run, tile))
        kernel = lambda: mergepath_sort.merge_pass(state, splits, run=run, tile=tile, out=spare)
        if run in (chunk, total // 2):
            plain = lambda: mergepath_sort.merge_pass_plain(state, splits, run=run, tile=tile)
            at.hold(kernel(), plain())
            pass_times[run] = turn_about(kernel, plain, plain_reps=2, warm=1)
            # the library call of the same function: the sort of every run pair
            pass_library_ms[run] = timed_ms(
                lambda: torch.sort(state.view(-1, 2 * run), dim=1), reps=3, warm=1)
            pass_ms.append(pass_times[run]["ms"])
        else:
            pass_ms.append(timed_ms(kernel, reps=5, warm=1))
        state, spare = kernel(), state
        run *= 2
    at.hold(state[:n_keys], torch.sort(flat).values)
    del state, spare, splits
    entries.append(sort_entry(
        "merge_pass", "merge_pass_kernel", "genome_assembly_tpu/ops/mergepath_pallas.py:261",
        launches["merge_pass"], "mergepath_entry_point", tallies["merge_pass"], at,
        pass_times[total // 2], bound_fields([merge_pass_bound(total, tile, per_thread)]),
        pass_library_ms[total // 2], [total], source=source, tile=tile,
        keys_per_thread=per_thread, run=total // 2,
        library_call="torch.sort(x.view(-1, 2 * run), dim=1)",
        ms_at_smallest_run=pass_times[chunk]["ms"],
        plain_ms_at_smallest_run=pass_times[chunk]["plain_ms"],
        library_ms_at_smallest_run=pass_library_ms[chunk],
        ms_by_level=pass_ms, input="the sort's own state at each level"))
    # the split kernel: the entry is the LAST level's launch (the longest
    # search); no one PyTorch call computes the function
    entries.append(sort_entry(
        "merge_splits", "merge_splits_kernel", "genome_assembly_tpu/ops/mergepath_pallas.py:70",
        launches["merge_splits"], "mergepath_entry_point", tallies["merge_splits"], at_splits,
        {"ms": splits_ms[-1], "plain_ms": splits_plain_ms[-1]},
        bound_fields([splits_work[-1][:2]]), None, [total], source=source, tile=tile,
        run=total // 2, n_tiles=total // tile, dependent_steps=splits_work[-1][2],
        ms_by_level=splits_ms, plain_ms_by_level=splits_plain_ms,
        ms_all_levels=sum(splits_ms), plain_ms_all_levels=sum(splits_plain_ms),
        dependent_steps_by_level=[w[2] for w in splits_work],
        input="the sort's own state at each level"))

    # the composed sort, at the main path's key count
    want = torch.sort(flat).values
    at = Tally()
    at.hold(mergepath_sort.sort_keys_mergepath(flat), want)
    at.hold(plain_mergepath(flat, tile, base_run, chunk), want)
    del want
    at.hold(mergepath_sort.sort_keys_mergepath(real_keys), torch.sort(real_keys).values)
    library_ms = timed_ms(lambda: torch.sort(flat), reps=3, warm=1)
    runs_ms = [timed_ms(lambda: mergepath_sort.sort_keys_mergepath(flat), reps=3, warm=1)
               for _ in range(4)]
    times = {"ms": min(runs_ms),
             "plain_ms": timed_ms(lambda: plain_mergepath(flat, tile, base_run, chunk),
                                  reps=1, warm=0)}
    library_real = timed_ms(lambda: torch.sort(real_keys), reps=3, warm=1)
    real_ms = [timed_ms(lambda: mergepath_sort.sort_keys_mergepath(real_keys), reps=3, warm=1)
               for _ in range(4)]
    library_real = min(library_real, timed_ms(lambda: torch.sort(real_keys), reps=3, warm=1))
    # the library's row sorts, where there are any, count as one pass over the keys
    passes = [pass_bound(total, 0)] * (base_run > 1) + [main["bound"]] * (base_run < chunk)
    passes += [merge_pass_bound(total, tile, per_thread)] * len(pass_ms)
    passes += [w[:2] for w in splits_work]
    entries.append(sort_entry(
        "sort_keys_mergepath", "local_merge_kernel, merge_pass_kernel, merge_splits_kernel",
        "genome_assembly_tpu/ops/mergepath_pallas.py:371",
        launches["local_merge"] + launches["merge_pass"] + launches["merge_splits"],
        "mergepath_entry_point (kernel launches of one sort_keys_mergepath call)",
        tallies["sort_keys_mergepath"], at, times, bound_fields(passes), library_ms, [n_keys],
        source="genome_assembly_tpu_torch/ops/mergepath_sort.py", composite=True,
        tile=tile, base_run=base_run, chunk=chunk, padded_to=total, passes=len(passes),
        library_call="torch.sort(x)", row_sort_ms=row_sort_ms, splits_ms=sum(splits_ms),
        local_merge_ms=entries[0]["ms"], merge_pass_ms_sum=sum(pass_ms),
        ms_runs=runs_ms, ms_real_keys=min(real_ms), ms_real_keys_runs=real_ms,
        library_ms_real_keys=library_real))
    return entries


def phase_tile_choice(device, n_keys):
    """What the merge-path sort's defaults should be, over the padded
    main-path key count.  K4a for chunk 2^13 and 2^14, 8, 16 and 32 keys a
    thread, from base_run 1 (the whole chunk sort) and from library rows of
    2^10; one K4b pass (run = total / 2) for tile 2^10 .. 2^13 and 4, 8 and 16
    keys a thread, and the split search beside it; sort_keys_mergepath of the
    main path's key count over base_run, over tile and keys a thread, and over
    chunk, there and back.  For
    the record, with no switch behind it: K2 sort_rows on [total / chunk,
    chunk], which yields the array K4a yields from base_run 1."""
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    chunk = mergepath_sort.DEFAULT_MERGE_CHUNK
    flat = random_keys(gen, n_keys, device, 0.3)
    padded = bitonic_sort._padded_copy(flat, chunk)
    total = padded.shape[0]
    rows_ms = timed_ms(lambda: torch.sort(padded.view(-1, EARLIER_BASE_RUN), dim=1),
                       reps=3, warm=1)
    sort_rows_ms = timed_ms(lambda: bitonic_sort.sort_rows(padded.view(-1, chunk)), reps=3, warm=1)
    before = (mergepath_cuda.KEYS_PER_THREAD, mergepath_cuda.LOCAL_KEYS_PER_THREAD)
    local, passes, sorts = [], [], []

    def sort_ms(**kwargs):
        return timed_ms(lambda: mergepath_sort.sort_keys_mergepath(flat, **kwargs), reps=5, warm=1)

    try:
        for base in (1, EARLIER_BASE_RUN):
            rows = chunk_runs(padded, base)
            for c in (1 << 13, 1 << 14):
                levels = merge_levels(base, c)
                for wanted in (8, 16, 32):
                    mergepath_cuda.LOCAL_KEYS_PER_THREAD = wanted
                    local.append({
                        "base_run": base, "chunk": c,
                        "keys_per_thread": mergepath_cuda._keys_per_thread(wanted, c),
                        "local_merge_ms": timed_ms(
                            lambda: mergepath_sort.local_merge(rows, levels, chunk=c),
                            reps=3, warm=1)})
            del rows
        del padded
        mergepath_cuda.LOCAL_KEYS_PER_THREAD = before[1]
        halves = sorted_runs(bitonic_sort._padded_copy(flat, chunk), total // 2)
        spare = torch.empty_like(halves)
        for tile in (1 << 10, 1 << 11, 1 << 12, 1 << 13):
            splits = mergepath_sort.merge_splits(halves, total // 2, tile)
            splits_ms = timed_ms(lambda: mergepath_sort.merge_splits(halves, total // 2, tile))
            for wanted in (4, 8, 16):
                mergepath_cuda.KEYS_PER_THREAD = wanted
                passes.append({
                    "tile": tile, "keys_per_thread": mergepath_cuda._keys_per_thread(wanted, tile),
                    "merge_splits_ms": splits_ms, "merge_pass_ms": timed_ms(
                        lambda: mergepath_sort.merge_pass(halves, splits, run=total // 2,
                                                          tile=tile, out=spare), reps=5, warm=1)})
        mergepath_cuda.KEYS_PER_THREAD = before[0]
        del halves, spare, splits
        for base in (1, EARLIER_BASE_RUN, EARLIER_BASE_RUN, 1):
            sorts.append({"base_run": base, "tile": mergepath_sort.DEFAULT_MERGE_TILE,
                          "chunk": chunk, "sort_keys_mergepath_ms": sort_ms(base_run=base)})
        grid = [(1 << 12, 4), (1 << 12, 8), (1 << 11, 4), (1 << 11, 8), (1 << 10, 4), (1 << 13, 8)]
        for tile, wanted in grid + grid[::-1]:
            mergepath_cuda.KEYS_PER_THREAD = wanted
            sorts.append({"base_run": mergepath_sort.DEFAULT_BASE_RUN, "tile": tile, "chunk": chunk,
                          "keys_per_thread": wanted,
                          "sort_keys_mergepath_ms": sort_ms(tile=tile)})
        mergepath_cuda.KEYS_PER_THREAD = before[0]
        for c in (1 << 13, 1 << 14, 1 << 14, 1 << 13):
            sorts.append({"base_run": mergepath_sort.DEFAULT_BASE_RUN,
                          "tile": mergepath_sort.DEFAULT_MERGE_TILE, "chunk": c,
                          "sort_keys_mergepath_ms": sort_ms(chunk=c)})
    finally:
        mergepath_cuda.KEYS_PER_THREAD, mergepath_cuda.LOCAL_KEYS_PER_THREAD = before
    emit("tile_choice", n_keys=n_keys, padded_to=total,
         default_base_run=mergepath_sort.DEFAULT_BASE_RUN,
         default_tile=mergepath_sort.DEFAULT_MERGE_TILE, default_chunk=chunk,
         default_keys_per_thread=before[0], default_local_keys_per_thread=before[1],
         library_row_sort_ms=rows_ms, sort_rows_kernel_ms_on_chunk_rows=sort_rows_ms,
         local_merge=local, merge_pass=passes, sorts=sorts)


def plain_network(key, first_unit, chunk):
    """sort_keys (first_unit == chunk) or sort_keys_hybrid (first_unit ==
    lib_chunk) composed of the PLAIN passes, on the card: what the composed
    sorts' plain_ms is."""
    n = key.shape[0]
    buf = bitonic_sort._padded_copy(key, first_unit)
    if first_unit == chunk:
        buf = bitonic_sort.chunk_sort_plain(buf, levels_up_to(chunk), chunk=chunk)
    else:
        buf = torch.sort(buf.view(-1, first_unit), dim=1).values
        buf[1::2] = buf[1::2].flip(1)
        buf = buf.view(-1)
    size = 2 * first_unit
    while size <= buf.shape[0]:
        d = size // 2
        while d >= chunk:
            buf = bitonic_sort.big_ce_plain(buf, d, size)
            d //= 2
        buf = bitonic_sort.finish_plain(buf, size, chunk=chunk)
        size *= 2
    return buf[:n]


def phase_chunk_choice(device, n_keys):
    """What chunk size and keys a thread finish should default to: finish
    over the padded main-path key count at level == total for chunk 2^12 ..
    2^14 and 8, 16 and 32 keys a thread (where a block of chunk / keys
    threads fits), there and back, and the hybrid sort of the main path's key
    count at each chunk (default keys a thread)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    lib = bitonic_sort.DEFAULT_LIB_CHUNK
    flat = random_keys(gen, n_keys, device, 0.3)
    key = bitonic_sort._padded_copy(flat, lib)
    total = key.shape[0]
    grid, hybrid = [], []
    shapes = [(chunk, per_thread) for chunk in (1 << 12, 1 << 13, 1 << 14)
              for per_thread in (8, 16, 32) if chunk // per_thread <= 1024]
    for chunk, per_thread in shapes + shapes[::-1]:
        with finish_keys_per_thread(per_thread):
            threads, _, groups, shared_bytes = bitonic_cuda.finish_shape(chunk)
            grid.append({
                "chunk": chunk, "keys_per_thread": per_thread, "threads": threads,
                "shared_exchanges": len(groups) - 1, "shared_bytes": shared_bytes,
                "finish_ms": timed_ms(lambda: bitonic_sort.finish(key, total, chunk=chunk), reps=5)})
    order = (1 << 13, 1 << 14, 1 << 14, 1 << 13, 1 << 12)
    for chunk in order:
        hybrid.append({"chunk": chunk, "sort_keys_hybrid_ms": timed_ms(
            lambda: bitonic_sort.sort_keys_hybrid(flat, chunk=chunk), reps=3, warm=1)})
    emit("chunk_choice", n_keys=n_keys, padded_to=total, lib_chunk=lib,
         default_chunk=bitonic_sort.DEFAULT_CHUNK,
         default_keys_per_thread=bitonic_cuda.FINISH_KEYS_PER_THREAD, passes=grid, hybrid=hybrid)


def phase_rows_choice(device):
    """What block the two merge sorts should default to.  K2 on 2^26 keys as
    rows of C = 64, 1024, 4096 and 2^14, for blocks of C, 2048, 4096 and 2^14
    keys (whole rows: at least C, and at least one thread's keys), then the
    default once more, beside the library's row sort; and what a round costs:
    K3a on 2^28 keys for every last level 2 .. 2^14 in blocks of 2^14 keys (the
    levels up to the keys a thread run in registers, every later one is a
    round)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(13)
    largest = bitonic_cuda.MAX_SHARED_KEYS
    key = random_keys(gen, 1 << 28, device, 0.3)
    quarter = key[: 1 << 26]
    rows_grid, by_level = [], []

    def shape_fields(run):
        block_keys, threads, shared_bytes = bitonic_cuda.block_shape(run)
        return {"block_keys": block_keys, "threads": threads, "shared_bytes": shared_bytes}

    def rows_ms(rows):
        return timed_ms(lambda: bitonic_sort.sort_rows(rows), reps=5, warm=1)

    for c in (64, 1024, 4096, largest):
        rows = quarter.view(-1, c)
        library_ms = timed_ms(lambda: torch.sort(rows, dim=1), reps=3, warm=1)
        seen = set()
        for block_keys in (2, 2048, 4096, largest):
            with merge_sort_block(block_keys):
                shape = shape_fields(c)
                if shape["block_keys"] not in seen:
                    seen.add(shape["block_keys"])
                    rows_grid.append({"C": c, **shape, "sort_rows_ms": rows_ms(rows)})
        rows_grid.append({"C": c, **shape_fields(c), "default": True, "library_ms": library_ms,
                          "sort_rows_ms": rows_ms(rows)})
    with merge_sort_block(largest):
        for top in levels_up_to(largest):
            sizes = levels_up_to(top)
            by_level.append({"top": top, **shape_fields(top), "chunk_sort_ms": timed_ms(
                lambda: bitonic_sort.chunk_sort(key, sizes, chunk=largest), reps=5, warm=1)})
    emit("rows_choice", rows_keys=quarter.shape[0], chunk_sort_keys=key.shape[0],
         default_block_keys=bitonic_cuda.BLOCK_KEYS, keys_per_thread=bitonic_cuda.KEYS_PER_THREAD,
         sort_rows=rows_grid, chunk_sort_by_last_level=by_level)


def load_libraries(csrc_dir):
    """{stem: library} built from the sources in `csrc_dir`, beside this
    tree's in the build directory (a library is named by its sources'
    hash), with the argument types of the launchers timed against another
    commit's: those of K1, K3c and K4a, and K5's where its source is a plain
    C library (before its launch became a torch operator)."""
    before = csrc_build.CSRC_DIR, dict(csrc_build._loaded)
    csrc_build.CSRC_DIR = pathlib.Path(csrc_dir).resolve()
    csrc_build._loaded.clear()
    stems = ["fast_scan", "bitonic", "mergepath"]
    gather_source = csrc_build.CSRC_DIR / "lane_gather.cu"
    if gather_source.exists() and csrc_build.operator_source(gather_source) is None:
        stems.append("lane_gather")
    try:
        libs = {stem: csrc_build.load(stem) for stem in stems}
    finally:
        csrc_build.CSRC_DIR, loaded = before
        csrc_build._loaded.clear()
        csrc_build._loaded.update(loaded)
    ptr, i32, i64, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
    text = (pathlib.Path(csrc_dir) / "fast_scan.cu").read_text()
    # the scan's launcher took no `valid` output before the kernel wrote it
    scan_writes_valid = "valid_out" in text.split("fast_scan_launch(", 1)[1].split(")", 1)[0]
    libs["fast_scan"].fast_scan_launch.argtypes = (
        [ptr] * (5 if scan_writes_valid else 4) + [i32] * 4 + [ptr])
    libs["bitonic"].finish_launch.argtypes = [ptr, ptr, i64, i32, u64, i32, ptr]
    libs["mergepath"].local_merge_launch.argtypes = [ptr, ptr, i64, i32, i32, i32, i32, ptr]
    if "lane_gather" in libs:
        libs["lane_gather"].lane_gather_launch.argtypes = [ptr, ptr, ptr, i64, i32, i32, i32, ptr]
    # the last int of finish_launch was the threads of a block before it was
    # the keys a thread (the stage-by-stage kernel ran 1024 threads a block)
    finish_per_thread = bitonic_cuda.finish_shape(bitonic_cuda.MAX_SHARED_KEYS)[1]
    finish_last = (finish_per_thread if "finish_shared_launch_bytes"
                   in (pathlib.Path(csrc_dir) / "bitonic.cu").read_text() else 1024)
    return libs, scan_writes_valid, finish_last


def ctypes_lane_gather(lib):
    """K5 through a plain C library, with the host path the port had before
    its launch became a torch operator: the checks, the output, the data
    pointers and the raw stream in Python, the arguments converted by ctypes,
    and a launcher that takes the card and sets it and reads its
    multiprocessors itself."""
    def gather(x, idx):
        lane_gather.check(x, idx)
        if not x.is_cuda:
            raise ValueError("lane_gather needs CUDA tensors")
        if not (x.is_contiguous() and idx.is_contiguous()):
            raise ValueError("lane_gather needs contiguous tensors")
        rows, cols = x.shape
        card = x.device.index
        out = torch.empty_like(x)
        err = lib.lane_gather_launch(x.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, cols,
                                     x.element_size(), card,
                                     torch._C._cuda_getCurrentRawStream(card))
        if err != 0:
            raise RuntimeError(f"lane_gather kernel launch failed: cudaError {err}")
        return out
    return gather


def phase_against(device, other_csrc):
    """K1, K3c, K4a and K5 of this tree beside those of another copy of csrc/
    (another commit's, say ``git archive <commit> genome_assembly_tpu_torch/csrc``
    unpacked somewhere), on one card in one process, in the order other,
    this, this, other.  K1, K3c and K4a are launched through their C
    launchers: K1 on the first batch of the ecoli reads, K3c on 2^28 keys at
    level 2^28 in chunks of 2^14, K4a on 2^28 keys in chunks of 2^14 from
    single keys and from runs of 2^10.  K5 is launched as a user calls it:
    this tree's through its torch operator, the other's (where its source
    is a plain C library) through ``ctypes_lane_gather``, at the probe's
    shapes and at [65536, 1024] int32, with ``ms``, ``device_ms`` and
    ``host_us`` as ``time_lane_gather`` takes them, and this tree's host
    time split (the OpOverload, the C++ callable under it, and the
    ``empty_like`` inside it) timed in the same rounds.  Every result is held:
    K1's m-mers and keys (and `valid`, where the launcher writes it) against
    fast_scan_plain, K3c against finish_plain, K4a against the library's
    sort of every chunk, K5 against torch.gather."""
    libs = {"other": load_libraries(other_csrc), "this": load_libraries(csrc_build.CSRC_DIR)}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    t, runs = Tally(), []

    def turns(kernel, launch, hold, reps=7, **fields):
        for name in ("other", "this", "this", "other"):
            if launch(name) != 0:
                raise AssertionError(f"{kernel} of {name} csrc/: the launch failed")
            hold(name)
            runs.append({"kernel": kernel, "csrc": name, **fields,
                         "ms": timed_ms(lambda: launch(name), reps=reps, warm=1)})

    # K1
    _, reads = coverage_reads(ECOLI["genome_len"], ECOLI["read_len"], ECOLI["coverage"], seed=0)
    cfg = ecoli_config()
    batch = reads_io.batch_reads(reads[: cfg.batch_reads], cfg.max_read_len, cfg.batch_reads)[0]
    del reads
    codes = torch.from_numpy(batch.codes).to(device)
    lengths = torch.from_numpy(batch.lengths).to(device)
    want = minimizer.fast_scan_plain(codes, lengths, k=cfg.k, m=cfg.m)
    got = minimizer.WindowRecords(*(torch.empty_like(x) for x in want))
    b_rows, max_len = codes.shape

    def scan(name):
        lib, writes_valid, _ = libs[name]
        outs = [got.mmer.data_ptr(), got.kmer.data_ptr()] + [got.valid.data_ptr()] * writes_valid
        return lib["fast_scan"].fast_scan_launch(codes.data_ptr(), lengths.data_ptr(), *outs,
                                                 b_rows, max_len, cfg.k, cfg.m, stream())

    def hold_scan(name):
        got.valid.fill_(False)
        scan(name)
        t.hold(got.mmer, want.mmer)
        t.hold(got.kmer, want.kmer)
        if libs[name][1]:
            t.hold(got.valid, want.valid)

    turns("fast_scan", scan, hold_scan, reps=21, shape=list(codes.shape))
    del codes, lengths, want, got

    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    chunk = bitonic_cuda.MAX_SHARED_KEYS
    key = random_keys(gen, 1 << 28, device, 0.3)
    out = torch.empty_like(key)

    # K3c
    n_chunks = key.shape[0] // chunk
    want = bitonic_sort.finish_plain(key, key.shape[0], chunk=chunk)

    def finish(name):
        lib, _, last = libs[name]
        return lib["bitonic"].finish_launch(key.data_ptr(), out.data_ptr(), n_chunks, chunk,
                                            key.shape[0], last, stream())

    turns("finish", finish, lambda name: t.hold(out, want), n_keys=key.shape[0],
          size=key.shape[0], chunk=chunk)
    del want

    # K4a
    want = torch.sort(key.view(-1, chunk), dim=1).values.view(-1)
    per_thread = mergepath_cuda.LOCAL_KEYS_PER_THREAD
    for base_run in (1, EARLIER_BASE_RUN):
        state = chunk_runs(key, base_run)

        def local_merge(name):
            return libs[name][0]["mergepath"].local_merge_launch(
                state.data_ptr(), out.data_ptr(), n_chunks, chunk, base_run, chunk, per_thread,
                stream())

        turns("local_merge", local_merge, lambda name: t.hold(out, want), n_keys=key.shape[0],
              chunk=chunk, base_run=base_run)
    del key, out, want, state

    # K5
    other_gather = libs["other"][0].get("lane_gather")
    gathers = {"this": lane_gather_cuda.lane_gather_cuda}
    if other_gather is not None:
        gathers["other"] = ctypes_lane_gather(other_gather)
    gather_host_us = []
    for shape, calls in (((256, 128), 50), ((256, 1024), 50), ((65536, 1024), 10)):
        x, idx = lane_gather_input(gen, shape, torch.int32, "random", device)
        want = torch.gather(x, 1, idx.long())
        for name in ("other", "this", "this", "other"):
            if name not in gathers:
                continue
            fn = gathers[name]
            t.hold(fn(x, idx), want)
            run = lambda: fn(x, idx)  # noqa: E731
            runs.append({
                "kernel": "lane_gather", "csrc": name, "shape": list(shape),
                "host_path": "torch operator" if name == "this" else "ctypes",
                "ms": timed_ms(run, calls=calls),
                "device_ms": statistics.median(timed_ms_runs(run, calls=calls,
                                                             spin_cycles=SPIN_CYCLES))})
        # where this tree's host time goes: the wrapper (a Python frame)
        # calls the OpOverload (a Python frame), which calls the C++ callable
        # (arguments boxed, the dispatcher, the operator's host path, in
        # which empty_like is one more dispatch and the allocator)
        op = torch.ops.ga_torch.lane_gather.default
        split = {"op_overload": lambda: op(x, idx), "cpp_callable": lambda: op._op(x, idx),
                 "empty_like": lambda: torch.empty_like(x)}
        gather_host_us.append({"shape": list(shape), "rounds": HOST_ROUNDS, **host_us(
            {**{name: (lambda fn=fn: fn(x, idx)) for name, fn in gathers.items()}, **split},
            calls)})
    emit("against", other_csrc=str(other_csrc), runs=runs, lane_gather_host_us=gather_host_us,
         lane_gather_other="ctypes" if other_gather is not None else
         "not run: the other tree's K5 is an operator library too (one a process)",
         **t.report())
    if t.mismatches:
        raise AssertionError(f"against: {t.mismatches} mismatches")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--coverage", type=int, default=ECOLI["coverage"],
                    help="coverage of the ecoli read set of full_e2e and hybrid_e2e "
                         "(the preset's is 50)")
    ap.add_argument("--against", metavar="DIR",
                    help="only time fast_scan, finish, local_merge and lane_gather of this tree "
                         "against those of the copy of genome_assembly_tpu_torch/csrc/ in DIR, "
                         "in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = phase_env()
    if args.against:
        phase_against(device, args.against)
        return 0
    phase_build()
    scan_tally, gather_tally = phase_kernel_check(device)
    prims_launches = phase_prims(device)
    phase_small_e2e(device)
    phase_parity_golden(device)
    parity_runs = phase_parity_e2e_and_dirty(device)
    phase_parity_scale(device)
    full = phase_full_e2e(device, args.coverage)
    phase_surfaces_e2e(device, full, parity_runs)
    tallies = phase_sort_check(device)
    tallies.update(phase_merge_check(device))
    hybrid_launches = phase_hybrid_e2e(device, full)
    torch.cuda.empty_cache()
    mesh_launches, mesh_scan_tally, mesh_batch, mesh2_procs = phase_mesh_e2e(
        device, full, parity_runs)
    scan_tally = (scan_tally[0] + mesh_scan_tally[0], max(scan_tally[1], mesh_scan_tally[1]))
    del parity_runs
    mesh2_launches, mesh2_scan_tally = phase_mesh2_e2e(device, full, mesh_batch, mesh2_procs)
    scan_tally = (scan_tally[0] + mesh2_scan_tally[0], max(scan_tally[1], mesh2_scan_tally[1]))
    phase_comm_model(device, full, mesh_batch)
    del mesh_batch
    phase_ooc_extension(device, full, args.coverage)
    phase_ooc_e2e(device)
    phase_parity_ooc_golden(device)
    phase_parity_ooc_scale(device)
    torch.cuda.empty_cache()
    phase_scale_checks(device)
    phase_ext_modes(device)
    torch.cuda.empty_cache()
    chr1_launches = phase_scale_chr1(device)
    n_keys = full["fields"]["window_slots"]
    first_batch, scan_launches = full["first_batch"], full["launches"]["fast_scan"]
    real_keys = scanned_keys(full["reads"], ecoli_config(), device)
    del full
    entry_launches = phase_sort_entry_points(device, n_keys)
    torch.cuda.empty_cache()
    merge_launches = phase_mergepath_entry_point(device, n_keys, real_keys)
    torch.cuda.empty_cache()
    kernels = [time_scan(device, first_batch, scan_launches, scan_tally, chr1_launches,
                         mesh_launches, mesh2_launches)]
    kernels += time_sort_kernels(device, tallies, hybrid_launches, entry_launches, n_keys)
    torch.cuda.empty_cache()
    kernels += time_merge_kernels(device, tallies, merge_launches, n_keys, real_keys)
    del real_keys
    torch.cuda.empty_cache()
    kernels.append(time_lane_gather(device, prims_launches, gather_tally))
    phase_chunk_choice(device, n_keys)
    torch.cuda.empty_cache()
    phase_tile_choice(device, n_keys)
    torch.cuda.empty_cache()
    phase_rows_choice(device)
    for entry in kernels:
        if entry["mismatches"] or not entry["launches"]:
            raise AssertionError(
                f"{entry['name']}: {entry['mismatches']} mismatches, "
                f"{entry['launches']} launches on its path")
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

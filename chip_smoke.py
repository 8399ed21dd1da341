#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py            # every phase, needs one CUDA device

Builds the port's CUDA kernels from genome_assembly_tpu_torch/csrc/, holds
each kernel against its plain tensor version on the card (bit-exact: all
results on this path are integers), runs fast-mode in-core assembly end to
end through ``FastAssembler.unitigs`` at a small size (card vs CPU) and at
the size of the repo's ``ecoli`` scale preset, and prints one JSON object
per phase.  Exits non-zero if there is no CUDA device or any phase fails.
Imports nothing of JAX and nothing of the JAX package.

Last three lines of standard output: the card's name and power limit as
nvidia-smi gives them, the ``kernels`` report, and the verdict.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from genome_assembly_tpu_torch.common import SENTINEL
from genome_assembly_tpu_torch.config import PipelineConfig
from genome_assembly_tpu_torch.csrc import build as csrc_build
from genome_assembly_tpu_torch.io import datagen
from genome_assembly_tpu_torch.io import reads as reads_io
from genome_assembly_tpu_torch.io import stream as stream_io
from genome_assembly_tpu_torch.models.pipeline import FastAssembler
from genome_assembly_tpu_torch.ops import count as count_ops
from genome_assembly_tpu_torch.ops import dbg
from genome_assembly_tpu_torch.ops import minimizer
from genome_assembly_tpu_torch.ops import minimizer_cuda

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate,
# and the float32 rate outside the tensor cores, taken here as the peak for
# 32-bit integer ALU operations (the data sheet gives no integer rate).
PEAK_BYTES_PER_S = 3.35e12
PEAK_ALU_OPS_PER_S = 67e12

# The repo's `ecoli` scale preset (tools/run_scale.py), M as in bench.py.
ECOLI = dict(genome_len=4_600_000, coverage=50, read_len=100, k=31, m=7,
             batch_reads=65536, max_read_len=128, cutoff=1)

KERNEL_SHAPE = (65536, 128)


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


def coverage_reads(genome_len, read_len, coverage, seed):
    """Uniform-coverage error-free reads, half of them reverse-complemented,
    made with vectorised numpy.  Returns (genome, reads)."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    comp = np.zeros(256, dtype=np.uint8)
    comp[letters] = np.frombuffer(b"TGCA", dtype=np.uint8)
    genome = letters[rng.integers(0, 4, size=genome_len)]
    n_reads = int(genome_len * coverage / read_len)
    starts = rng.integers(0, genome_len - read_len + 1, size=n_reads)
    chars = genome[starts[:, None] + np.arange(read_len)[None, :]]
    flip = rng.random(n_reads) < 0.5
    chars[flip] = comp[chars[flip]][:, ::-1]
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


def phase_build():
    t0 = time.perf_counter()
    libs = csrc_build.build_all(verbose=True)
    minimizer_cuda._library()
    emit("build", seconds=time.perf_counter() - t0,
         libraries=sorted(str(p.name) for p in libs.values()))


def compare_scan(codes, lengths, k, m):
    """(mismatching elements, max |kernel - plain|) over mmer, kmer, valid."""
    got = minimizer.fast_scan(codes, lengths, k=k, m=m)
    want = minimizer.fast_scan_plain(codes, lengths, k=k, m=m)
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


def phase_kernel_check(device):
    rng = np.random.default_rng(1234)
    cases = [(KERNEL_SHAPE[0], KERNEL_SHAPE[1], 31, 7)]
    for k, m in [(31, 7), (21, 7), (17, 5), (16, 5), (15, 5), (31, 4)]:
        cases.append((1000, 128, k, m))
        cases.append((1000, 100, k, m))
    cases += [(1, 128, 31, 7), (3, 31, 31, 7), (257, 1000, 31, 15)]
    report, total, worst = [], 0, 0.0
    for batch, max_len, k, m in cases:
        codes, lengths = random_batch(rng, batch, max_len, device)
        mism, err = compare_scan(codes, lengths, k, m)
        report.append({"B": batch, "L": max_len, "k": k, "m": m, "mismatches": mism})
        total += mism
        worst = max(worst, err)
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
    emit("kernel_check", tolerance=0, mismatches=total, max_abs_err=worst,
         refused_bad_inputs=refused, cases=report)
    if total or refused != 6:
        raise AssertionError(f"kernel_check failed: {total} mismatches, {refused}/6 refusals")
    return total, worst


def kept_table(reads, cfg, device):
    """Sorted kept canonical keys of a read set, by the ops alone."""
    batches = reads_io.batch_reads(reads, cfg.max_read_len, cfg.batch_reads)
    keys = []
    for codes, lengths, _ in stream_io.feed_read_batches(batches, device):
        keys.append(minimizer.fast_scan(codes, lengths, k=cfg.k, m=cfg.m).kmer.reshape(-1))
    key = torch.cat(keys)
    del keys
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


def phase_full_e2e(device, coverage):
    p = dict(ECOLI, coverage=coverage)
    t0 = time.perf_counter()
    genome, reads = coverage_reads(p["genome_len"], p["read_len"], p["coverage"], seed=0)
    t_reads = time.perf_counter() - t0
    cfg = PipelineConfig(k=p["k"], m=p["m"], parity=False, abundance_cutoff=p["cutoff"],
                         batch_reads=p["batch_reads"], max_read_len=p["max_read_len"])
    n_batches = -(-len(reads) // cfg.batch_reads)
    asm = FastAssembler(cfg, device=device)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    minimizer_cuda.launch_count = 0
    t0 = time.perf_counter()
    unitigs, stats = asm.unitigs(reads)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = minimizer_cuda.launch_count
    peak = torch.cuda.max_memory_allocated()

    if launches != n_batches:
        raise AssertionError(f"{launches} kernel launches for {n_batches} batches")
    t0 = time.perf_counter()
    kept = kept_table(reads, cfg, device)
    if kept.size != stats.entries_post_prune:
        raise AssertionError("kept table size differs from entries_post_prune")
    check_exactly_once(unitigs, kept, cfg.k)
    longest = max(unitigs, key=len)
    if longest not in genome and dbg._rc_str(longest) not in genome:
        raise AssertionError("longest unitig is not a substring of the genome")
    t_check = time.perf_counter() - t0
    slots = n_batches * cfg.batch_reads * cfg.windows_per_read
    emit("full_e2e", preset="ecoli", genome_len=p["genome_len"], coverage=p["coverage"],
         coverage_cut=p["coverage"] != ECOLI["coverage"],
         read_len=p["read_len"], k=cfg.k, m=cfg.m, batch_reads=cfg.batch_reads,
         max_read_len=cfg.max_read_len, n_batches=n_batches, window_slots=slots,
         key_bytes=slots * 8, launches=launches,
         phase_seconds=dict(read_generation_host=t_reads, **stats.wall_s),
         assemble_wall_seconds=wall,
         kmers_counted_per_s=stats.n_windows / (stats.wall_s["scan"] + stats.wall_s["count"]),
         extension_states_per_s=2 * stats.entries_post_prune
         / (stats.wall_s["links"] + stats.wall_s["jump"]),
         max_memory_allocated=peak, n_unitigs=len(unitigs), longest_unitig=len(longest),
         exactly_once=True, longest_in_genome=True, check_seconds=t_check,
         **counters(stats))
    # the first batch of this run is what the kernel is timed on
    first = reads_io.batch_reads(reads[: cfg.batch_reads], cfg.max_read_len, cfg.batch_reads)[0]
    return launches, first


def timed_ms(fn, reps=9, warm=2):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_kernels(device, launches, batch, mismatches, max_err):
    """Time K1 and its plain version on one batch of the main path
    ([65536, 128], k=31, m=7, the reads of full_e2e), turn about."""
    k, m = ECOLI["k"], ECOLI["m"]
    codes = torch.from_numpy(batch.codes).to(device)
    lengths = torch.from_numpy(batch.lengths).to(device)
    if tuple(codes.shape) != KERNEL_SHAPE:
        raise AssertionError(f"main-path batch is {tuple(codes.shape)}, not {KERNEL_SHAPE}")

    def kernel():
        return minimizer.fast_scan(codes, lengths, k=k, m=m)

    def plain():
        return minimizer.fast_scan_plain(codes, lengths, k=k, m=m)

    plain_a = timed_ms(plain, reps=5)
    kernel_a = timed_ms(kernel)
    kernel_b = timed_ms(kernel)
    plain_b = timed_ms(plain, reps=5)
    ms = min(kernel_a, kernel_b)
    plain_ms = min(plain_a, plain_b)

    # bound: each input read once, each output (mmer 4 B, kmer 8 B, valid
    # 1 B per window slot) written once; operations as the kernel's loops
    # need them for THIS batch: 5 per base of every m-mer position, and per
    # window that exists 5 64-bit (= 10 32-bit) per base plus one min per
    # m-mer position of the window
    b_rows, max_len = codes.shape
    n_win, n_mpos = max_len - k + 1, max_len - m + 1
    n_valid = int((torch.arange(n_win, device=device)[None, :] + k <= lengths[:, None]).sum())
    n_bytes = b_rows * max_len + 4 * b_rows + 13 * b_rows * n_win
    n_ops = b_rows * n_mpos * 5 * m + n_valid * (10 * k + (k - m + 1))
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_ALU_OPS_PER_S * 1e3
    entry = {
        "name": "fast_scan",
        "route": "cuda",
        "source": "genome_assembly_tpu_torch/csrc/fast_scan.cu",
        "replaces": "genome_assembly_tpu/ops/minimizer_pallas.py:25",
        "launches": launches,
        "max_abs_err": max_err,
        "mismatches": mismatches,
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bound_bytes_ms": bytes_ms,
        "bound_operations_ms": ops_ms,
        "library_ms": None,
        "shape": list(KERNEL_SHAPE), "k": k, "m": m,
        "kernel_ms_runs": [kernel_a, kernel_b], "plain_ms_runs": [plain_a, plain_b],
    }
    return {"kernels": [entry]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--coverage", type=int, default=ECOLI["coverage"],
                    help="coverage of the full_e2e read set (the preset's is 50)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = phase_env()
    phase_build()
    mismatches, max_err = phase_kernel_check(device)
    phase_small_e2e(device)
    launches, first_batch = phase_full_e2e(device, args.coverage)
    kernels = phase_kernels(device, launches, first_batch, mismatches, max_err)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

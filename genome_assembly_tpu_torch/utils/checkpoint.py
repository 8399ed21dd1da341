"""Checkpoints in the JAX package's file formats (``utils/checkpoint.py``
there), so a file written by either package loads in the other.

A counted table (``save_counted_table``) is a compressed npz of the JAX
package's ``CountedTable`` fields and dtypes (uint32 m-mer and k-mer lanes,
read ids and stream indices, bool masks, int32 counts) beside a
``.meta.json`` of the format version, the phase and the run's config under
the JAX package's ``PipelineConfig`` field names: this package's
``hybrid_sort`` is written as ``pallas_sort`` (with ``pallas_scan`` false)
and read back from it, and a ``pallas_scan`` read is dropped (on a card the
scan is always the kernel).  A stream index past 2^32 - 1 does not fit the
JAX package's lane: the lane is then written as int64 (this package reads
it back whole; the JAX package's own file would have wrapped).

A pointer-jump frontier is the doubling table of
``dbg.pointer_jump_bulk`` after some round: ``frontier_l<lanes>.npz``
(``tbl`` int32 [2N, lanes], ``pred`` int32 [2N], ``rounds_done`` int64;
uncompressed, as the table is near-random ids) beside
``frontier_l<lanes>.meta.json`` (the format version and a fingerprint of
the link array it was taken from).  This package's int64 state ids are
saved as int32 (the JAX package's single-array jump holds fewer than 2^31
states too) and read back as int64.

Count shards (``save_count_shards``, ``load_count_shards``) are the records
a distributed count holds after some batches: one ``shard_<g>.npz`` a
global shard, written by the process that owns it, with the valid records
only (``mmer``, ``khi``, ``klo`` uint32; ``rid``, ``stream`` uint32 where
every value fits, int64 past 2^32 - 1; ``ovf`` int64), then
``manifest.json`` (the commit point: format, shard count, batches done and
the run's fields), all written through a temporary name and renamed.

Numpy and json only, plus torch for the fingerprint's two sums and the
count shards' tensors.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
from typing import Tuple

import numpy as np
import torch

from genome_assembly_tpu_torch.common import MASK32, MMER_SENTINEL
from genome_assembly_tpu_torch.config import PipelineConfig
from genome_assembly_tpu_torch.ops.count import CountedTable

FORMAT_VERSION = 1

# the JAX package's CountedTable fields, in its order
_TABLE_FIELDS = ("mmer", "kmer_hi", "kmer_lo", "read_id", "stream_idx", "valid",
                 "group_start", "count", "keep")


def fits_uint32(x: np.ndarray) -> np.ndarray:
    """``x`` (non-negative integers) as uint32 when every value fits, else
    as int64: never wrapped."""
    x = np.asarray(x)
    if x.size and int(x.max()) > MASK32:
        return x.astype(np.int64)
    return x.astype(np.uint32)


def _config_to_jax(config: PipelineConfig) -> dict:
    """This package's config under the JAX package's field names, in its
    order (``pallas_scan``, ``pallas_sort`` after ``max_read_len``)."""
    fields = dataclasses.asdict(config)
    hybrid = fields.pop("hybrid_sort")
    out = {}
    for name, value in fields.items():
        out[name] = value
        if name == "max_read_len":
            out["pallas_scan"] = False
            out["pallas_sort"] = hybrid
    return out


def _config_from_jax(fields: dict) -> PipelineConfig:
    fields = dict(fields)
    fields.pop("pallas_scan", None)
    fields["hybrid_sort"] = fields.pop("pallas_sort", False)
    return PipelineConfig(**fields)


def _npz_path(path) -> pathlib.Path:
    p = pathlib.Path(path)
    return p if p.suffix == ".npz" else p.with_suffix(p.suffix + ".npz")


def save_counted_table(path, table: CountedTable, config: PipelineConfig, phase: str) -> None:
    """Serialize a counted table (device or host tensors) + metadata, as
    the JAX package's ``save_counted_table`` writes it."""
    from genome_assembly_tpu_torch import convert

    p = _npz_path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    arrays = dict(zip(_TABLE_FIELDS, convert.counted_table_to_lanes(table)))
    arrays["stream_idx"] = fits_uint32(convert._np(table.stream_idx))
    np.savez_compressed(p, **arrays)
    meta = {
        "format_version": FORMAT_VERSION,
        "phase": phase,
        "config": _config_to_jax(config),
    }
    p.with_suffix(".meta.json").write_text(json.dumps(meta, indent=2))


def load_counted_table(path) -> Tuple[CountedTable, PipelineConfig, str]:
    """Restore a counted table written by either package: (table of CPU
    tensors, config, phase)."""
    from genome_assembly_tpu_torch import convert

    p = _npz_path(path)
    meta = json.loads(p.with_suffix(".meta.json").read_text())
    if meta["format_version"] != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {meta['format_version']}")
    data = np.load(p)
    table = convert.counted_table_from_lanes(*(data[name] for name in _TABLE_FIELDS))
    return table, _config_from_jax(meta["config"]), meta["phase"]


def jump_fingerprint(next_state) -> dict:
    """Content fingerprint of a link array: its length and the wrapping
    32-bit sums of the low and high 16-bit halves of each link as an int32
    (the JAX package's, value for value: a -1 link's high half is all
    ones).  Reduced where the links lie; two scalars come back."""
    ns = torch.as_tensor(next_state)
    lo = int((ns & 0xFFFF).sum() & MASK32)
    hi = int(((ns >> 16) & MASK32).sum() & MASK32)
    return {"n2": int(ns.shape[0]), "sum_lo": lo, "sum_hi": hi}


def _int32(x) -> np.ndarray:
    """int32 numpy; a tensor is narrowed where it lies, so half the bytes
    cross to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.int32).cpu().numpy()
    return np.asarray(x).astype(np.int32)


def save_jump_frontier(dirpath, tbl, pred, rounds_done: int, lanes: int,
                       fingerprint: dict) -> None:
    """Save a doubling frontier (tensors or arrays of state ids < 2^31).
    Written to a temporary name and renamed, so a kill mid-save leaves the
    previous frontier whole."""
    d = pathlib.Path(dirpath)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f".frontier_l{lanes}.tmp.npz"
    np.savez(tmp, tbl=_int32(tbl), pred=_int32(pred), rounds_done=np.int64(rounds_done))
    (d / f"frontier_l{lanes}.meta.json").write_text(
        json.dumps({"format_version": FORMAT_VERSION, **fingerprint}))
    os.replace(tmp, d / f"frontier_l{lanes}.npz")


def load_jump_frontier(dirpath, lanes: int, fingerprint: dict):
    """(tbl, pred, rounds_done) of the saved frontier of this exact link
    array -- tbl, pred int64 numpy -- or None when there is none (a
    fingerprint of another array counts as none)."""
    d = pathlib.Path(dirpath)
    final = d / f"frontier_l{lanes}.npz"
    meta_path = d / f"frontier_l{lanes}.meta.json"
    if not final.exists() or not meta_path.exists():
        return None
    if json.loads(meta_path.read_text()) != {"format_version": FORMAT_VERSION, **fingerprint}:
        return None
    data = np.load(final)
    return (data["tbl"].astype(np.int64), data["pred"].astype(np.int64),
            int(data["rounds_done"]))


def clear_jump_frontier(dirpath, lanes: int) -> None:
    d = pathlib.Path(dirpath)
    for name in (f"frontier_l{lanes}.npz", f"frontier_l{lanes}.meta.json"):
        p = d / name
        if p.exists():
            p.unlink()


SHARDED_FORMAT = 1


def _barrier(mesh) -> None:
    if mesh.group is not None:
        import torch.distributed as dist

        dist.barrier(group=mesh.group)


def _valid_rows(parts, lane: int) -> np.ndarray:
    """One lane of a shard's record parts, rows with a record only, on the
    host (int64)."""
    out = [p[lane][p[0] != MMER_SENTINEL].to(torch.int64).cpu().numpy() for p in parts]
    return np.concatenate(out) if out else np.zeros(0, dtype=np.int64)


def save_count_shards(dirpath, shards, batches_done: int, meta: dict, *, mesh) -> None:
    """Checkpoint the records a distributed count holds.

    shards: one list a local shard (in ``mesh.local`` order) of record
    parts, each ``[mmer, kmer, read id, stream, overflow]`` as
    ``shard_count.sharded_count_batches`` accumulates them (FILLS rows are
    dropped).  Each process writes its shards' files; after a barrier the
    process of shard 0 writes the manifest, and a second barrier returns
    only once it is committed.  meta: the run's fields (k, m, parity,
    batch_rows, max_len, route_by), checked on load."""
    from genome_assembly_tpu_torch import convert

    d = pathlib.Path(dirpath)
    d.mkdir(parents=True, exist_ok=True)
    for g, parts in zip(mesh.local, shards):
        hi, lo = convert.key_to_lanes(_valid_rows(parts, 1))
        payload = {
            "mmer": _valid_rows(parts, 0).astype(np.uint32), "khi": hi, "klo": lo,
            "rid": fits_uint32(_valid_rows(parts, 2)),
            "stream": fits_uint32(_valid_rows(parts, 3)),
            "ovf": np.int64(sum(int(p[4]) for p in parts)),
        }
        tmp = d / f".shard_{g}.tmp.npz"
        np.savez(tmp, **payload)
        os.replace(tmp, d / f"shard_{g}.npz")
    _barrier(mesh)
    if 0 in mesh.local:
        manifest = {"format": SHARDED_FORMAT, "n_shards": mesh.n_shards,
                    "batches_done": int(batches_done), **meta}
        tmp = d / ".manifest.tmp.json"
        tmp.write_text(json.dumps(manifest))
        os.replace(tmp, d / "manifest.json")
    _barrier(mesh)


def load_count_shards(dirpath, *, mesh, expect: dict):
    """The count shards saved in ``dirpath`` for this mesh, or None when
    there is no manifest.

    Returns (one record part a local shard -- ``[mmer, kmer, read id,
    stream, overflow]`` on the shard's device, every shard padded with
    FILLS to the longest shard's rows, the overflow total on shard 0 --
    and the batches done).  A field of ``expect`` that differs from the
    manifest raises ValueError (an absent ``route_by`` is ``"mmer"``).
    Saved on another shard count, every record is routed again on the host
    by the manifest's owner hash."""
    from genome_assembly_tpu_torch import convert
    from genome_assembly_tpu_torch.parallel import shard_count

    d = pathlib.Path(dirpath)
    mpath = d / "manifest.json"
    if not mpath.exists():
        return None
    manifest = json.loads(mpath.read_text())
    if manifest["format"] != SHARDED_FORMAT:
        raise ValueError(f"unsupported sharded checkpoint {manifest}")
    for key, val in expect.items():
        have = manifest.get(key, "mmer" if key == "route_by" else None)
        if have != val:
            raise ValueError(f"checkpoint {d} was written by a different run: "
                             f"{key}={have!r} != {val!r}")
    parts, ovf_total = [], 0
    for g in range(manifest["n_shards"]):
        data = np.load(d / f"shard_{g}.npz")
        parts.append([
            torch.from_numpy(data["mmer"].astype(np.int32)),
            torch.from_numpy(convert.lanes_to_key(data["khi"], data["klo"])),
            torch.from_numpy(data["rid"].astype(np.int64)),
            torch.from_numpy(data["stream"].astype(np.int64)),
        ])
        ovf_total += int(data["ovf"])
    if manifest["n_shards"] != mesh.n_shards:
        cat = [torch.cat(lane) for lane in zip(*parts)]
        if manifest.get("route_by", "mmer") == "key":
            owner = shard_count.key_owner_of(cat[1], mesh.n_shards)
        else:
            owner = shard_count.owner_of(cat[0], mesh.n_shards)
        parts = [[lane[owner == g] for lane in cat] for g in range(mesh.n_shards)]
    width = max(1, max(p[0].shape[0] for p in parts))
    out = []
    for g in mesh.local:
        lanes = []
        for lane, fill in zip(parts[g], shard_count.FILLS):
            buf = lane.new_full((width,), fill)
            buf[:lane.shape[0]] = lane
            lanes.append(buf.to(mesh.devices[g]))
        ovf = torch.tensor(ovf_total if g == 0 else 0, dtype=torch.int64)
        out.append(lanes + [ovf.to(mesh.devices[g])])
    return out, int(manifest["batches_done"])

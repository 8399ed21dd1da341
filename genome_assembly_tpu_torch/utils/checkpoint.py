"""Pointer-jump frontier checkpoints, in the JAX package's file format.

A frontier is the doubling table of ``dbg.pointer_jump_bulk`` after some
round: ``frontier_l<lanes>.npz`` (``tbl`` int32 [2N, lanes], ``pred`` int32
[2N], ``rounds_done`` int64; uncompressed, as the table is near-random ids)
beside ``frontier_l<lanes>.meta.json`` (the format version and a
fingerprint of the link array it was taken from).  The files are the JAX
package's (``utils/checkpoint.py``) name for name and byte layout for byte
layout, so a frontier written by either package resumes in the other;
this package's int64 state ids are saved as int32 (the JAX package's
single-array jump holds fewer than 2^31 states too) and read back as int64.

Numpy and json only, plus torch for the fingerprint's two sums.
"""

from __future__ import annotations

import json
import os
import pathlib

import numpy as np
import torch

from genome_assembly_tpu_torch.common import MASK32

FORMAT_VERSION = 1


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

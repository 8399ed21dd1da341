"""ctypes bindings for the C++ parity replay engine (``replay_engine.cpp``).

The library is built by ``native/build.py`` at the first call that needs
it; importing this module builds and loads nothing.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

_lib = None

_U32P = ctypes.POINTER(ctypes.c_uint32)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _load():
    global _lib
    if _lib is None:
        from genome_assembly_tpu_torch.native import build

        lib = ctypes.CDLL(str(build.build()))
        lib.ga_parity_replay.restype = ctypes.c_int
        lib.ga_parity_replay.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            _U32P, _U32P, _U32P, _I64P, _I32P,
            ctypes.c_int, ctypes.POINTER(ctypes.c_char_p), _I64P,
        ]
        lib.ga_parity_replay_raw.restype = ctypes.c_int
        lib.ga_parity_replay_raw.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            _U32P, _U32P, _U32P, _I64P, _I32P,
            ctypes.c_int64, _I64P, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.POINTER(ctypes.c_char_p), _I64P,
        ]
        lib.ga_free.restype = None
        lib.ga_free.argtypes = [ctypes.c_char_p]
        _lib = lib
    return _lib


def available() -> bool:
    """True when the engine builds (or is built) and loads."""
    try:
        _load()
    except (OSError, RuntimeError):  # no g++, a failed build, a library that does not load
        return False
    return True


def _lanes(kmer: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """int64 keys -> the engine's (hi, lo) uint32 lanes: for k >= 16 the
    split is at 32 bits, for k < 16 hi is 0 and lo the whole key, which
    is the same shift and mask."""
    kmer = np.asarray(kmer, dtype=np.int64)
    return (kmer >> 32).astype(np.uint32), (kmer & 0xFFFFFFFF).astype(np.uint32)


def _take_text(lib, out_text: ctypes.c_char_p, encoding: str) -> str:
    text = out_text.value.decode(encoding) if out_text.value is not None else ""
    lib.ga_free(out_text)
    return text


def replay(
    mmer: np.ndarray,
    kmer: np.ndarray,
    id_offsets: np.ndarray,
    read_ids: np.ndarray,
    k: int,
    m: int,
    cutoff: int,
    verbose: bool = False,
) -> Tuple[str, Tuple[int, int, int]]:
    """Run the native replay over insertion-ordered groups.

    Arrays must be sorted by first-seen stream index; ``kmer`` holds int64
    keys; read_ids is the flattened per-group occurrence lists in stream
    (ascending) order with id_offsets delimiting groups.  Returns the
    output text and the engine's (pre-prune, post-prune, post-extension)
    entry counts.
    """
    lib = _load()
    mmer = np.ascontiguousarray(mmer, dtype=np.uint32)
    kmer_hi, kmer_lo = _lanes(kmer)
    id_offsets = np.ascontiguousarray(id_offsets, dtype=np.int64)
    read_ids = np.ascontiguousarray(read_ids, dtype=np.int32)
    out_text = ctypes.c_char_p()
    stats = (ctypes.c_int64 * 3)()
    rc = lib.ga_parity_replay(
        k, m, cutoff, len(mmer),
        mmer.ctypes.data_as(_U32P),
        kmer_hi.ctypes.data_as(_U32P),
        kmer_lo.ctypes.data_as(_U32P),
        id_offsets.ctypes.data_as(_I64P),
        read_ids.ctypes.data_as(_I32P),
        1 if verbose else 0,
        ctypes.byref(out_text),
        stats,
    )
    text = _take_text(lib, out_text, "utf-8")
    if rc != 0:
        raise RuntimeError(f"native parity replay aborted: {text}")
    return text, (int(stats[0]), int(stats[1]), int(stats[2]))


def assemble_groups(
    groups, k: int, m: int, cutoff: int, verbose: bool = False
):
    """Run the native replay over insertion-ordered STRING groups.

    groups: [(mmer_str, kmer_str, [read ids in stream order])], as built
    by parity/nonacgt.regroup_with_exceptions -- key strings may contain
    raw non-ACGT bytes, which ride the override channel
    (ga_parity_replay_raw) instead of the packed lanes.
    """
    from genome_assembly_tpu_torch.ops import encode

    lib = _load()
    n = len(groups)
    mmer = np.zeros(n, dtype=np.uint32)
    kmer = np.zeros(n, dtype=np.int64)
    offsets = np.zeros(n + 1, dtype=np.int64)
    raw_idx = []
    raw_m = bytearray()
    raw_k = bytearray()
    ids_parts = []
    pure = frozenset("TGCA")
    for g, (sig, key, id_list) in enumerate(groups):
        if len(sig) != m or len(key) != k:
            raise ValueError(f"group {g}: key lengths != (m={m}, k={k})")
        if pure.issuperset(sig) and pure.issuperset(key):
            mmer[g] = encode.pack_str(sig)
            kmer[g] = encode.pack_str(key)
        else:
            raw_idx.append(g)
            raw_m.extend(sig.encode("latin-1"))
            raw_k.extend(key.encode("latin-1"))
        offsets[g + 1] = offsets[g] + len(id_list)
        ids_parts.append(np.asarray(id_list, dtype=np.int32))
    flat_ids = np.concatenate(ids_parts) if ids_parts else np.zeros(0, np.int32)
    khi, klo = _lanes(kmer)
    raw_idx_a = np.asarray(raw_idx, dtype=np.int64)
    out_text = ctypes.c_char_p()
    stats = (ctypes.c_int64 * 3)()
    rc = lib.ga_parity_replay_raw(
        k, m, cutoff, n,
        mmer.ctypes.data_as(_U32P),
        khi.ctypes.data_as(_U32P),
        klo.ctypes.data_as(_U32P),
        offsets.ctypes.data_as(_I64P),
        flat_ids.ctypes.data_as(_I32P),
        len(raw_idx_a),
        raw_idx_a.ctypes.data_as(_I64P),
        bytes(raw_m),
        bytes(raw_k),
        1 if verbose else 0,
        ctypes.byref(out_text),
        stats,
    )
    text = _take_text(lib, out_text, "latin-1")
    if rc != 0:
        raise RuntimeError(f"native parity replay aborted: {text}")
    if verbose:
        return text
    return text.splitlines()


def assemble(host_table, k: int, m: int, cutoff: int, verbose: bool = False):
    """HostTable (pre-prune extraction) -> output text/lines via native replay."""
    order = np.argsort(np.asarray(host_table.first_seen), kind="stable")
    sizes = np.asarray(host_table.count)[order].astype(np.int64)
    offsets = np.zeros(len(order) + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    flat_ids = np.concatenate(
        [np.asarray(host_table.read_ids[g], dtype=np.int32) for g in order]
    ) if len(order) else np.zeros(0, dtype=np.int32)
    text, _stats = replay(
        np.asarray(host_table.mmer)[order], np.asarray(host_table.kmer)[order],
        offsets, flat_ids, k, m, cutoff, verbose=verbose,
    )
    if verbose:
        return text
    return text.splitlines()

"""A 1-D mesh of shards and its collectives.

The scaling design: read batches are split by row across the shards; the
count table is partitioned by owner (minimizer or key hash), with records
routed by an all-to-all exchange.  One axis covers both roles.

A ``ShardMesh`` has ``n_shards`` shards, the device of each, the shard ids
this process owns (``local``) and, across processes, a
``torch.distributed`` process group.  Every per-shard step of the parallel
modules is a plain function over ONE shard's tensors; the drivers loop over
``local``.  Every collective is a method that takes one tensor per local
shard (in ``local`` order) and returns one tensor per local shard.

The mesh has two forms:

- **One process, N shards** (``make_mesh``).  An exchange is a list of
  slices and copies, each to the destination shard's device.  Several
  shards may share one device (a CPU mesh of 8 shards, or 4 shards on one
  card); on a machine with several cards there is one shard a card and the
  copies are peer copies.
- **One process a shard** (``distributed.global_mesh``): ``local`` holds the
  process's own rank and the exchanges are ``torch.distributed``
  collectives (``all_to_all_single``, with split sizes for the ragged one)
  on the shard's own tensors, under NCCL or gloo alike (gloo takes card
  tensors as they are: ``chip_smoke.py`` runs it so on an H100).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


class ShardMesh:
    """``n_shards`` shards, each on a device, ``local`` of them in this process.

    devices: the device of every shard.  In a distributed mesh each process
      addresses only its own shard; every entry names that process's device.
    local: the shard ids this process owns, ascending.
    group: the ``torch.distributed`` process group of a distributed mesh
      (one shard a process), or None for a one-process mesh.
    """

    def __init__(self, devices: Sequence, *, local: Optional[Sequence[int]] = None,
                 group=None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.n_shards = len(self.devices)
        if self.n_shards < 1:
            raise ValueError("a mesh needs at least one shard")
        self.local = tuple(range(self.n_shards)) if local is None else tuple(local)
        self.group = group
        if group is not None and len(self.local) != 1:
            raise ValueError("a distributed mesh holds one shard a process")

    def __repr__(self) -> str:
        return (f"ShardMesh(n_shards={self.n_shards}, local={self.local}, "
                f"devices={[str(d) for d in self.devices]}, "
                f"distributed={self.group is not None})")

    # ------------------------------------------------------------------
    # placing data
    # ------------------------------------------------------------------

    def shard_rows(self, x) -> List[torch.Tensor]:
        """Split ``x`` (a tensor or numpy array of the whole batch) by rows
        into ``n_shards`` equal blocks; returns the local shards' blocks on
        their devices."""
        x = torch.as_tensor(np.ascontiguousarray(x) if isinstance(x, np.ndarray) else x)
        if x.shape[0] % self.n_shards:
            raise ValueError(f"{x.shape[0]} rows do not split over {self.n_shards} shards")
        rows = x.shape[0] // self.n_shards
        return [x[s * rows:(s + 1) * rows].to(self.devices[s]) for s in self.local]

    def to_host(self, xs: Sequence[torch.Tensor]) -> np.ndarray:
        """Every shard's tensor (equal shapes) on the host, stacked
        ``[n_shards, ...]``; across processes through an all-gather."""
        if self.group is None:
            return np.stack([x.detach().cpu().numpy() for x in xs])
        full = self.all_gather([xs[0].reshape(1, *xs[0].shape)])[0]
        return full.cpu().numpy()

    # ------------------------------------------------------------------
    # collectives
    # ------------------------------------------------------------------

    def all_to_all(self, blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Block ``j`` of every shard goes to shard ``j``.

        blocks: one ``[n_shards, cap, ...]`` tensor a local shard.  Returns
        one ``[n_shards, cap, ...]`` tensor a local shard whose row ``i``
        came from shard ``i``."""
        if self.group is not None:
            import torch.distributed as dist

            (b,) = blocks
            out = torch.empty_like(b)
            dist.all_to_all_single(out, b.contiguous(), group=self.group)
            return [out]
        out = []
        for j in self.local:
            dst = torch.empty((self.n_shards, *blocks[0].shape[1:]),
                              dtype=blocks[0].dtype, device=self.devices[j])
            for i, b in enumerate(blocks):
                dst[i].copy_(b[j])
            out.append(dst)
        return out

    def all_to_all_ragged(self, rows: Sequence[torch.Tensor],
                          send_sizes: Sequence[Sequence[int]]) -> List[torch.Tensor]:
        """Ragged exchange: exactly ``send_sizes[i][j]`` rows of local shard
        ``i`` go to shard ``j``.

        rows: one tensor a local shard, its rows packed by destination (the
        rows for shard 0 first, then shard 1 ...).  Returns one tensor a
        local shard: the rows sent to it, in source-shard order."""
        send_sizes = [[int(v) for v in sizes] for sizes in send_sizes]
        if self.group is not None:
            import torch.distributed as dist

            (x,) = rows
            (sizes,) = send_sizes
            recv = self.all_to_all([torch.tensor(sizes, dtype=torch.int64,
                                                 device=x.device)])[0].tolist()
            out = x.new_empty((sum(recv), *x.shape[1:]))
            dist.all_to_all_single(out, x.contiguous(), output_split_sizes=recv,
                                   input_split_sizes=sizes, group=self.group)
            return [out]
        starts = [np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist() for sizes in send_sizes]
        out = []
        for j in self.local:
            total = sum(sizes[j] for sizes in send_sizes)
            dst = torch.empty((total, *rows[0].shape[1:]), dtype=rows[0].dtype,
                              device=self.devices[j])
            at = 0
            for i, x in enumerate(rows):
                size = send_sizes[i][j]
                dst[at:at + size].copy_(x[starts[i][j]:starts[i][j] + size])
                at += size
            out.append(dst)
        return out

    def all_gather(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every shard's tensor (equal shapes), concatenated in shard order
        along dim 0, on each local shard's device.  Local shards on one
        device share one result."""
        if self.group is not None:
            import torch.distributed as dist

            (x,) = xs
            parts = [torch.empty_like(x) for _ in range(self.n_shards)]
            dist.all_gather(parts, x.contiguous(), group=self.group)
            return [torch.cat(parts)]
        by_device: Dict[torch.device, torch.Tensor] = {}
        for s in self.local:
            dev = self.devices[s]
            if dev not in by_device:
                by_device[dev] = torch.cat([x.to(dev) for x in xs])
        return [by_device[self.devices[s]] for s in self.local]

    def psum(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sum over every shard of one tensor a shard (equal shapes), on
        each local shard's device."""
        if self.group is not None:
            import torch.distributed as dist

            (x,) = xs
            total = x.clone()
            dist.all_reduce(total, group=self.group)
            return [total]
        total = sum(x.to(self.devices[self.local[0]]) for x in xs)
        return [total.to(self.devices[s]) for s in self.local]

    def total(self, xs: Sequence[torch.Tensor]) -> int:
        """psum of one scalar a shard, read back to the host."""
        return int(self.psum([x.reshape(()).to(torch.int64) for x in xs])[0])


def _check_devices(devices) -> List[torch.device]:
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"a mesh was asked for {d} and this machine has no CUDA device; "
                    "pass devices=['cpu'] for a CPU mesh")
            if d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    return out


def make_mesh(n_shards: Optional[int] = None, devices=None) -> ShardMesh:
    """A one-process mesh of ``n_shards`` shards.

    devices: a device or a list of them.  By default every visible CUDA
    device; without one this raises (a CPU mesh is built only when asked
    for, ``devices=["cpu"]``).  ``n_shards`` defaults to the number of
    devices; with fewer shards than devices the first ones are used, with
    more, consecutive shards share a device (shard ``s`` on device
    ``s * len(devices) // n_shards``).
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() takes the visible CUDA devices and this machine has "
                "none; pass devices=['cpu'] for a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    devices = _check_devices(devices)
    n = len(devices) if n_shards is None else int(n_shards)
    if n < 1:
        raise ValueError(f"n_shards must be >= 1; got {n}")
    if n <= len(devices):
        return ShardMesh(devices[:n])
    return ShardMesh([devices[s * len(devices) // n] for s in range(n)])

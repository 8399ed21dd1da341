"""A mesh of shards, with named axes, and its collectives.

The scaling design: read batches are split by row across the shards; the
count table is partitioned by owner (minimizer or key hash), with records
routed by an all-to-all exchange.  A flat (1-D) mesh covers both roles with
one axis.  A mesh of several axes, e.g. ``(n_slices, n_ici)`` or
``(n_slices, x, y)``, numbers its shards row-major (``g = ds * n_ici + dd``)
and exchanges along chosen axes: among the shards that share every other
coordinate (parallel/two_level.py routes in two such stages).

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
  tensors as they are: ``chip_smoke.py`` runs it so on an H100).  An
  exchange along some of the axes runs in the sub-group of the processes
  that share the other coordinates (``axis_groups``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

SLICE_AXIS = "slices"
SHARD_AXIS = "shards"


def default_axis_names(ndim: int) -> Tuple[str, ...]:
    """("shards",), ("slices", "shards") or ("slices", "x", "y")."""
    names = {1: (SHARD_AXIS,), 2: (SLICE_AXIS, SHARD_AXIS), 3: (SLICE_AXIS, "x", "y")}
    if ndim not in names:
        raise ValueError(f"name the axes of a {ndim}-axis mesh")
    return names[ndim]


def axis_members(shape: Sequence[int], g: int, axes: Tuple[int, ...]) -> List[int]:
    """The flat ids of the shards that share every coordinate of shard
    ``g`` off ``axes``, row-major over ``axes`` (so ascending)."""
    grid = np.arange(int(np.prod(shape))).reshape(tuple(shape))
    coords = np.unravel_index(g, tuple(shape))
    index = tuple(slice(None) if a in axes else coords[a] for a in range(len(shape)))
    return grid[index].reshape(-1).tolist()


class ShardMesh:
    """``n_shards`` shards, each on a device, ``local`` of them in this process.

    devices: the device of every shard.  In a distributed mesh each process
      addresses only its own shard; every entry names that process's device.
    local: the shard ids this process owns, ascending.
    group: the ``torch.distributed`` process group of a distributed mesh
      (one shard a process), or None for a one-process mesh.
    shape, axis_names: the axes (default one axis, ``("shards",)``); the
      flat shard id is the row-major index of the coordinates.
    axis_groups: in a distributed mesh of several axes, the sub-group of
      this process for each proper subset of the axes (a sorted tuple of
      axis indices), as ``distributed.global_mesh`` makes them.
    """

    def __init__(self, devices: Sequence, *, local: Optional[Sequence[int]] = None,
                 group=None, shape: Optional[Sequence[int]] = None,
                 axis_names: Optional[Sequence[str]] = None, axis_groups=None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.n_shards = len(self.devices)
        if self.n_shards < 1:
            raise ValueError("a mesh needs at least one shard")
        self.local = tuple(range(self.n_shards)) if local is None else tuple(local)
        self.group = group
        if group is not None and len(self.local) != 1:
            raise ValueError("a distributed mesh holds one shard a process")
        self.shape = (self.n_shards,) if shape is None else tuple(int(a) for a in shape)
        if int(np.prod(self.shape)) != self.n_shards:
            raise ValueError(f"a mesh of shape {self.shape} has {int(np.prod(self.shape))} "
                             f"shards, not {self.n_shards}")
        self.axis_names = (default_axis_names(len(self.shape)) if axis_names is None
                           else tuple(axis_names))
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"{len(self.axis_names)} axis names for {len(self.shape)} axes")
        self.axis_groups = dict(axis_groups or {})

    def __repr__(self) -> str:
        return (f"ShardMesh(n_shards={self.n_shards}, shape={self.shape}, "
                f"axis_names={self.axis_names}, local={self.local}, "
                f"devices={[str(d) for d in self.devices]}, "
                f"distributed={self.group is not None})")

    # ------------------------------------------------------------------
    # axes
    # ------------------------------------------------------------------

    def axes(self, axes=None) -> Tuple[int, ...]:
        """Axis indices, sorted, of None (every axis), a name, an index or
        a sequence of them."""
        if axes is None:
            return tuple(range(len(self.shape)))
        if isinstance(axes, (str, int)):
            axes = (axes,)
        out = sorted({self.axis_names.index(a) if isinstance(a, str) else int(a)
                      for a in axes})
        if not out or out[0] < 0 or out[-1] >= len(self.shape):
            raise ValueError(f"no axes {axes} in a mesh of axes {self.axis_names}")
        return tuple(out)

    def axis_size(self, axes=None) -> int:
        return int(np.prod([self.shape[a] for a in self.axes(axes)]))

    def members(self, g: int, axes=None) -> List[int]:
        """The shards of shard ``g``'s group along ``axes``, row-major."""
        return axis_members(self.shape, g, self.axes(axes))

    def _process_group(self, axes: Tuple[int, ...]):
        if len(axes) == len(self.shape):
            return self.group
        return self.axis_groups[axes]

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

    def all_to_all(self, blocks: Sequence[torch.Tensor], axes=None) -> List[torch.Tensor]:
        """Block ``j`` of every shard goes to the ``j``-th shard of its group
        along ``axes`` (default: every axis, the whole mesh).

        blocks: one ``[group size, cap, ...]`` tensor a local shard.
        Returns one such tensor a local shard whose row ``i`` came from the
        ``i``-th shard of its group."""
        axes = self.axes(axes)
        if self.group is not None:
            import torch.distributed as dist

            (b,) = blocks
            out = torch.empty_like(b)
            dist.all_to_all_single(out, b.contiguous(), group=self._process_group(axes))
            return [out]
        at = {s: i for i, s in enumerate(self.local)}
        out = []
        for j in self.local:
            group = self.members(j, axes)
            pos = group.index(j)
            dst = torch.empty((len(group), *blocks[0].shape[1:]),
                              dtype=blocks[0].dtype, device=self.devices[j])
            for i, src in enumerate(group):
                dst[i].copy_(blocks[at[src]][pos])
            out.append(dst)
        return out

    def ppermute(self, xs: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]],
                 axes=None) -> List[torch.Tensor]:
        """Each ``(src, dst)`` pair of ``perm`` (positions in a group along
        ``axes``) sends the ``src``-th shard's tensor to the ``dst``-th;
        a shard that no pair sends to gets zeros.  xs: one tensor a local
        shard, one shape on every shard."""
        axes = self.axes(axes)
        perm = [(int(a), int(b)) for a, b in perm]
        if self.group is not None:
            import torch.distributed as dist

            (x,) = xs
            (g,) = self.local
            size = self.axis_size(axes)
            pos = self.members(g, axes).index(g)
            dst = [b for a, b in perm if a == pos]
            src = [a for a, b in perm if b == pos]
            flat = x.contiguous().reshape(-1)
            n = flat.numel()
            sent = [n if dst and i == dst[0] else 0 for i in range(size)]
            got = [n if src and i == src[0] else 0 for i in range(size)]
            out = flat.new_empty(sum(got))
            dist.all_to_all_single(out, flat if dst else flat[:0], output_split_sizes=got,
                                   input_split_sizes=sent, group=self._process_group(axes))
            return [out.reshape(x.shape) if src else torch.zeros_like(x)]
        at = {s: i for i, s in enumerate(self.local)}
        out = []
        for j in self.local:
            group = self.members(j, axes)
            src = [a for a, b in perm if b == group.index(j)]
            if src:
                out.append(xs[at[group[src[0]]]].to(self.devices[j], copy=True))
            else:
                out.append(torch.zeros_like(xs[at[j]]))
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


def make_mesh(n_shards: Optional[int] = None, devices=None, *,
              shape: Optional[Sequence[int]] = None,
              axis_names: Optional[Sequence[str]] = None) -> ShardMesh:
    """A one-process mesh of ``n_shards`` shards.

    devices: a device or a list of them.  By default every visible CUDA
    device; without one this raises (a CPU mesh is built only when asked
    for, ``devices=["cpu"]``).  ``n_shards`` defaults to the number of
    devices; with fewer shards than devices the first ones are used, with
    more, consecutive shards share a device (shard ``s`` on device
    ``s * len(devices) // n_shards``).  shape, axis_names: the mesh's axes
    (``n_shards`` is then their product; default one axis).
    """
    if shape is not None:
        if n_shards is not None and int(n_shards) != int(np.prod(shape)):
            raise ValueError(f"{n_shards} shards do not make a mesh of shape {tuple(shape)}")
        n_shards = int(np.prod(shape))
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
    if n > len(devices):
        devices = [devices[s * len(devices) // n] for s in range(n)]
    return ShardMesh(devices[:n], shape=shape, axis_names=axis_names)


"""One process a shard: initialization, the global mesh, input slices.

A mesh inside one process needs none of this (``mesh.make_mesh``).  N >= 2
processes, each owning one device, coordinate through
``torch.distributed``:

- ``init_multi_host`` calls ``init_process_group``: gloo for CPU shards,
  NCCL for card shards, unless the caller names the backend (gloo also
  serves card shards).
  Without an address it reads torch's own ``MASTER_ADDR``, ``MASTER_PORT``,
  ``RANK`` and ``WORLD_SIZE``; nothing else is discovered.
- ``global_mesh`` is the mesh over all processes, one shard each, in rank
  order: one axis, or the ``shape`` asked for (row-major, so a slice of a
  ``(n_slices, n_ici)`` mesh is ``n_ici`` consecutive ranks), with one
  ``torch.distributed`` sub-group a process for every proper subset of the
  axes.
- ``host_read_slice`` gives each process its contiguous slice of a global
  read set.
"""

from __future__ import annotations

import itertools
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from genome_assembly_tpu_torch.parallel.mesh import ShardMesh, _check_devices, axis_members


def init_multi_host(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device="cuda",
) -> Tuple[int, int]:
    """Join the process group (a no-op for one process and no address).

    coordinator_address: ``host:port`` of rank 0's store (``tcp://``);
    None reads ``MASTER_ADDR``/``MASTER_PORT`` (``env://``).
    num_processes, process_id: default ``WORLD_SIZE`` and ``RANK`` (1, 0).
    backend: default NCCL for a CUDA ``device``, gloo for the CPU.
    Returns (rank, world size).
    """
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if num_processes > 1 or coordinator_address is not None:
        (device,) = _check_devices([device])
        if backend is None:
            backend = "nccl" if device.type == "cuda" else "gloo"
        if device.type == "cuda":
            torch.cuda.set_device(device)
        init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
        dist.init_process_group(backend, init_method=init, world_size=num_processes,
                                rank=process_id)
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def host_read_slice(n_reads: int) -> Tuple[int, int]:
    """[start, stop) of this process's slice of a global read set."""
    p, n = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    per = (n_reads + n - 1) // n
    start = p * per
    return start, min(n_reads, start + per)


def global_mesh(device="cuda", shape=None, axis_names=None) -> ShardMesh:
    """The mesh over every process of the group: shard ``r`` is rank ``r``,
    on this process's ``device`` (a CUDA device without an index means the
    current one, which ``init_multi_host`` set).

    shape, axis_names: the mesh's axes (default one axis over the world).
    Every process makes every sub-group (``dist.new_group``), in one order,
    and keeps its own: collective calls, so every process calls this with
    the same shape."""
    if not dist.is_initialized():
        raise RuntimeError("global_mesh() needs init_multi_host() first")
    (device,) = _check_devices([device])
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = (world,) if shape is None else tuple(int(a) for a in shape)
    if int(np.prod(shape)) != world:
        raise ValueError(f"a mesh of shape {shape} needs {int(np.prod(shape))} processes, "
                         f"the world has {world}")
    groups = {}
    # every non-empty proper subset of the axes, in one order on every process
    subsets = [c for r in range(1, len(shape))
               for c in itertools.combinations(range(len(shape)), r)]
    for axes in subsets:
        for g in range(world):
            members = axis_members(shape, g, axes)
            if members[0] != g:
                continue
            made = dist.new_group(ranks=members)
            if rank in members:
                groups[axes] = made
    return ShardMesh([device] * world, local=[rank], group=dist.group.WORLD, shape=shape,
                     axis_names=axis_names, axis_groups=groups)

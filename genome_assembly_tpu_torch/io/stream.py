"""Host -> device batch feeding.

A plain generator: each batch is copied to ``device`` as it is asked for.
On a CUDA device the host arrays are pinned and copied with
``non_blocking=True``, so the copy is queued on the current stream and
the host goes on to stage the next batch while the device works.  (The
JAX package's threaded ``DeviceFeeder`` has no counterpart here yet.)
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import torch

from genome_assembly_tpu_torch import convert


def feed_read_batches(
    batches: Sequence, device
) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Yield (codes uint8 [n, L], lengths int32 [n], read_ids int64 [n])
    tensors on ``device`` for each ``io.reads.ReadBatch``, in order."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    for b in batches:
        host = convert.read_batch_to_torch(b)
        if on_card:
            yield tuple(
                t.pin_memory().to(device, non_blocking=True) for t in host
            )
        else:
            yield host

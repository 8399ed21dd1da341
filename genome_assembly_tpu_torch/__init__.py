"""PyTorch/CUDA port of the de novo assembly engine (fast mode, in core).

The JAX package ``genome_assembly_tpu`` is the reference; this package is
its counterpart on an NVIDIA Hopper card.  Ported so far: the fast-mode
in-core path on one device,

  reads -> io.reads.batch_reads (host) -> ops.minimizer.fast_scan (the
  hand-written CUDA kernel csrc/fast_scan.cu on a CUDA tensor, its plain
  tensor version on a CPU tensor) -> ops.count.count_keys ->
  ops.count.kept_keys_sorted -> ops.dbg.build_unitig_links_join ->
  ops.dbg.pointer_jump -> ops.dbg.materialize_unitigs_device (the walk
  sort on the device, the strings on the host)

A packed k-mer is ONE int64 key, the plain 2k-bit MSB-first value (the
JAX package's ``(hi << 32) | lo``); the padding sentinel is int64 max
(``common.SENTINEL``).  ``convert`` maps between the two conventions.

Entry points take ``device`` and default to ``"cuda"``; nothing falls
back to the CPU on its own.  The package imports torch and numpy only.
"""

__version__ = "0.1.0"

from genome_assembly_tpu_torch.config import PipelineConfig

__all__ = ["PipelineConfig", "__version__"]

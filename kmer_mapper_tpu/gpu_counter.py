"""Drop-in module-path alias for ``kmer_mapper.gpu_counter``.

The reference's ``GpuCounter`` wraps the CUDA ``cucounter`` table
(``kmer_mapper/gpu_counter.py``); here the same class surface
(``from_kmers_and_nodes`` / ``initialize_cuda`` / ``count(..., count_revcomps)``
/ ``get_node_counts``) is backed by the block-chained device table and the
gather probe — see :class:`kmer_mapper_tpu.compat.TpuCounter`.
"""
from .compat import TpuCounter

GpuCounter = TpuCounter  # drop-in name

__all__ = ["GpuCounter", "TpuCounter"]

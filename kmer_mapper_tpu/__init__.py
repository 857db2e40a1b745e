"""kmer_mapper_tpu: a JAX/XLA k-mer mapping framework for the GPU.

From-scratch rebuild of the capabilities of ivargr/kmer_mapper: stream
FASTA/FASTQ (optionally gzipped) short reads, 2-bit-encode, extract
rolling-window k-mer hashes, probe them against a graph k-mer index resident
in device memory, and accumulate per-graph-node hit counts — bit-exact
against the reference's numpy/Cython semantics, scaling over several devices
via shard_map.
"""

from . import oracle
from .compat import TpuCounter, in_graph_index, map_kmers_to_graph_index
from .index.kmer_index import (
    TpuKmerIndex,
    load_index,
    load_reference_npz,
    save_reference_npz,
)
from .models.mapper import KmerMapper, MapperConfig, default_config
from .oracle import KmerIndexArrays, build_kmer_index
from .pipeline import map_file, map_file_sharded, map_sequences

__version__ = "0.1.0"

__all__ = [
    "oracle",
    "TpuKmerIndex",
    "load_index",
    "load_reference_npz",
    "save_reference_npz",
    "KmerIndexArrays",
    "build_kmer_index",
    "KmerMapper",
    "MapperConfig",
    "default_config",
    "map_file",
    "map_file_sharded",
    "map_sequences",
    "map_kmers_to_graph_index",
    "in_graph_index",
    "TpuCounter",
    "__version__",
]

"""Drop-in programmatic API matching the reference's library surface.

The reference is used as a library by KAGE: ``map_kmers_to_graph_index(index,
max_node_id, kmers, max_index_lookup_frequency)`` (``kmer_mapper/mapper.pyx:19``)
and ``in_graph_index(index, kmers)`` (``:81``). These wrappers accept either a
reference-layout :class:`~kmer_mapper_tpu.oracle.KmerIndexArrays`, a
:class:`~kmer_mapper_tpu.index.kmer_index.TpuKmerIndex`, or an index path, and
run on the accelerator when one is present (numpy oracle otherwise).
"""
from __future__ import annotations

import logging
import os
import weakref

import numpy as np

from . import oracle
from .index.kmer_index import TpuKmerIndex, load_index
from .models.mapper import KmerMapper, MapperConfig

logger = logging.getLogger(__name__)

# KAGE calls these wrappers repeatedly with the same index object/path
# (``mapper.pyx:19,81`` is its per-batch call surface); rebuilding the device
# table per call costs tens of seconds for a real index, so resolved indexes
# are cached (object keys are id()-based with weakref.finalize eviction — the
# arrays dataclass is not hashable) and the device-resident mapper lives ON
# the TpuKmerIndex, so it dies exactly when the index does (a global
# mapper cache would pin the index forever through mapper.index).
_path_cache: dict[str, TpuKmerIndex] = {}
_obj_cache: dict[int, TpuKmerIndex] = {}


def _as_device_index(index) -> TpuKmerIndex:
    if isinstance(index, TpuKmerIndex):
        return index
    if isinstance(index, (str, os.PathLike)):
        key = str(index)
        hit = _path_cache.get(key)
        if hit is None:
            hit = _path_cache[key] = load_index(index)
        return hit
    hit = _obj_cache.get(id(index))
    if hit is None:
        hit = load_index(index)
        _obj_cache[id(index)] = hit
        try:
            weakref.finalize(index, _obj_cache.pop, id(index), None)
        except TypeError:
            pass  # not weakref-able: entry persists for the process lifetime
    return hit


def _shared_mapper(dev_index: TpuKmerIndex, k: int = 31) -> KmerMapper:
    # keyed per k (not "the last k"): a library caller alternating k between
    # calls must not rebuild the device table / recompile every call — the
    # reference's call surface is k-agnostic (``mapper.pyx:19``)
    mappers = getattr(dev_index, "_compat_mappers", None)
    if mappers is None:
        mappers = dev_index._compat_mappers = {}
    mapper = mappers.get(k)
    if mapper is None:
        mapper = mappers[k] = KmerMapper(dev_index, MapperConfig(k=k, buf=256, max_reads=16))
    return mapper


def map_kmers_to_graph_index(
    index,
    max_node_id: int | None = None,
    kmers: np.ndarray | None = None,
    max_index_lookup_frequency: int = 1000,
) -> np.ndarray:
    """Per-node hit counts for a flat array of uint64 kmer hashes.

    Signature parity with ``kmer_mapper.mapper.map_kmers_to_graph_index``
    (``mapper.pyx:19-72``); unlike the reference CLI, the frequency cutoff
    argument is honored. Repeated calls with the same index reuse the cached
    device table (no rebuild)."""
    assert kmers is not None, "kmers required"
    dev_index = _as_device_index(index)
    mapper = _shared_mapper(dev_index)
    mapper.reset_counts()
    mapper.map_hashes(np.asarray(kmers, dtype=np.uint64))
    counts = mapper.node_counts(max_frequency=max_index_lookup_frequency)
    if max_node_id is not None and max_node_id + 1 != len(counts):
        if max_node_id + 1 < len(counts):
            logger.warning(
                "max_node_id=%d drops counts for %d higher nodes present in the "
                "index (the reference would write out of bounds here)",
                max_node_id,
                len(counts) - (max_node_id + 1),
            )
        out = np.zeros(max_node_id + 1, dtype=np.uint32)
        n = min(len(counts), max_node_id + 1)
        out[:n] = counts[:n]
        return out
    return counts


def in_graph_index(
    index, kmers: np.ndarray, max_index_lookup_frequency: int = 1000
) -> np.ndarray:
    """uint8[n] membership per kmer (``mapper.pyx:81-130``; the reference also
    ignores the frequency argument for membership)."""
    dev_index = _as_device_index(index)
    return _shared_mapper(dev_index).in_index(np.asarray(kmers, dtype=np.uint64))


class TpuCounter:
    """API-shaped counterpart of the reference's ``GpuCounter``
    (``kmer_mapper/gpu_counter.py``): build a device counter from the index's
    (kmers, nodes), stream uint64 hash batches through ``count`` (optionally
    with on-device reverse complements), then convert unique-kmer counts to
    node counts. Backed by the block-chained table + probe kernels instead of
    cucounter's CUDA atomics."""

    def __init__(self, unique_kmers, kmers, nodes, k: int):
        self.unique_kmers = np.asarray(unique_kmers, dtype=np.uint64)
        self.kmers = np.asarray(kmers, dtype=np.uint64)
        self.nodes = np.asarray(nodes, dtype=np.int32)
        self.k = k
        self._mapper: KmerMapper | None = None

    @classmethod
    def from_kmers_and_nodes(cls, kmers, nodes, k: int) -> "TpuCounter":
        return cls(np.unique(kmers), kmers, nodes, k)

    def initialize(self, *_ignored) -> None:
        """Build the device table (``initialize_cuda`` analog; the table size
        argument is ignored — sizing is derived from the key set)."""
        index = TpuKmerIndex.from_counter_keys(self.unique_kmers)
        self._mapper = KmerMapper(index, MapperConfig(k=self.k, buf=256, max_reads=16))

    initialize_cuda = initialize  # drop-in name

    def count(self, kmers, count_revcomps: bool = False) -> None:
        if self._mapper is None:
            self.initialize()
        kmers = np.asarray(kmers, dtype=np.uint64)
        self._mapper.map_hashes(kmers)
        if count_revcomps:
            self._mapper.map_hashes(oracle.revcomp_hash(kmers, self.k))

    def get_node_counts(self, min_nodes: int = 0) -> np.ndarray:
        """Distribute unique-kmer counts to index entries and bincount by node
        (``gpu_counter.py:26-37`` semantics: length = max(min_nodes,
        max_node + 1); uint32 rather than float64)."""
        assert self._mapper is not None, "count() nothing yet"
        got_kmers, got_counts = self._mapper.kmer_counts()
        out = oracle.node_counts_from_kmer_counts(
            self.kmers, self.nodes, got_kmers, got_counts, min_nodes=0
        )
        if len(out) < min_nodes:
            out = np.pad(out, (0, min_nodes - len(out)))
        return out


# numpy-only equivalents (no accelerator required)
map_kmers_to_graph_index_numpy = oracle.map_kmers_to_index
in_graph_index_numpy = oracle.in_index

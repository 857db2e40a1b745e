"""Multi-host scale-out.

The reference is strictly single-machine (SURVEY §5.8): a POSIX-shm process
pool. The multi-host analog: every host runs its own input pipeline
over a disjoint shard of the reads (k-mer counting is embarrassingly parallel
over reads), maps on its local devices, and the per-host node-count vectors
are summed once at the end — one cross-host all-reduce worth of traffic, total.

Two modes:

* **Global mesh** (jax.distributed): call :func:`initialize`, build the mesh
  over ``jax.devices()`` as usual (``make_mesh``), and feed each host its own
  file shard via :func:`host_shard`; ``ShardedKmerMapper.node_counts`` already
  ends in a replicated-output jit, so XLA performs the cross-host reduction.
* **Independent jobs**: run one ``map_file`` per host on its shard and combine
  the saved ``.npy`` vectors with :func:`merge_node_counts`.
"""
from __future__ import annotations

import jax
import numpy as np


def initialize(coordinator_address: str | None = None, **kwargs) -> None:
    """Bring up the JAX distributed runtime (idempotent wrapper).

    Must run before anything initializes an XLA backend — i.e. before
    importing ``kmer_mapper_tpu`` itself (module-level jnp constants touch the
    backend); this module is importable standalone for exactly that reason.
    """
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address, **kwargs)
    except RuntimeError as exc:  # already initialized: keep the existing runtime
        if "should only be called once" not in str(exc):
            raise


def host_shard(paths: list[str], process_index: int | None = None,
               process_count: int | None = None) -> list[str]:
    """The subset of input files this host should map (round-robin)."""
    i = jax.process_index() if process_index is None else process_index
    n = jax.process_count() if process_count is None else process_count
    return [p for j, p in enumerate(paths) if j % n == i]


def merge_node_counts(count_vectors) -> np.ndarray:
    """Sum per-host/per-shard node-count vectors (ragged-tolerant)."""
    arrays = [np.asarray(v) for v in count_vectors]
    n = max(len(a) for a in arrays)
    out = np.zeros(n, dtype=np.uint64)
    for a in arrays:
        out[: len(a)] += a.astype(np.uint64)
    return np.minimum(out, np.iinfo(np.uint32).max).astype(np.uint32)

"""Device mesh construction for the (data, index) parallel layout.

The reference's only parallelism is a CPU process pool over input chunks with
an additive reduce (``additative_shared_array_map_reduce``,
``command_line_interface.py:124-130``). The device layout generalizes it:

* **data axis** — chunks of reads are sharded across devices (the process-pool
  analog); each data row accumulates into its own count state, summed once at
  the end (the additive reduce, as a psum/jnp.sum over the axis).
* **index axis** — the unique-kmer table (the multi-GB "model state") is
  sharded by contiguous bucket ranges; every index shard probes the full
  query stream of its data row and counts only the keys it owns, so the hot
  loop needs NO collectives at all — communication happens once, at node-count
  finalization. Collectives run over NVLink between the GPUs of one host
  (every card reaches every other at the same rate, so the mesh is a plain
  reshape of the device list, shaped by the algorithm alone).
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"
INDEX_AXIS = "index"


def make_mesh(
    n_devices: int | None = None, index_parallel: int | None = None, devices=None
) -> Mesh:
    """Build a (data, index) mesh over the given/available devices.

    ``index_parallel`` defaults to 1 (replicated table) — the right choice
    whenever the table fits one device's memory; raise it for multi-GB indexes.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if index_parallel is None:
        index_parallel = 1
    assert n % index_parallel == 0, f"{n} devices not divisible by index={index_parallel}"
    grid = np.asarray(devices).reshape(n // index_parallel, index_parallel)
    return Mesh(grid, (DATA_AXIS, INDEX_AXIS))

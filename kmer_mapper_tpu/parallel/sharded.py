"""Multi-device mapping: shard_map chunk step + GSPMD finalization.

Layout (see ``mesh.py``): reads are data-parallel, the bucket table is
sharded by contiguous bucket ranges over the index axis. Each (data, index)
device probes its data row's full query stream against its local bucket range
and counts the keys it owns into a private count shard — the hot path is
collective-free by construction (the analog of the reference's race-free
private ``node_counts`` per worker, SURVEY §5.2). The additive reduce over the
data axis and the entry->node conversion happen once, at finalization, where
XLA's partitioner inserts the all-reduce/all-gathers (NCCL over NVLink on a
multi-GPU host).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..index.kmer_index import TpuKmerIndex
from ..models.mapper import MapperConfig, chunk_is_fixed
from ..ops import hashing, probe
from ..ops.u32hash import feistel_mix
from .mesh import DATA_AXIS, INDEX_AXIS

# counts are uint32[D, n_slots] in slot order: the index axis splits the slot
# range exactly like it splits the bucket range of the key arrays
_COUNTS = P(DATA_AXIS, INDEX_AXIS)
_KEYS = P(INDEX_AXIS, None)  # uint32[n_buckets, BUCKET_KEYS]
_ROW = P(DATA_AXIS, None)  # one array per data row
_SCALAR = P(DATA_AXIS)  # one scalar per data row


def _local_counter(mesh: Mesh, config: MapperConfig, n_buckets: int, max_probe: int):
    """Per-device probe + count of mixed query words against the device's
    bucket range (the shared core of every sharded step)."""
    n_index = mesh.shape[INDEX_AXIS]
    if n_buckets % n_index:
        raise ValueError(f"{n_buckets} buckets do not split over {n_index} index shards")
    nb_local = n_buckets // n_index
    accumulate = probe.ACCUMULATORS[config.accumulate]

    def count(c, key_lo, key_hi, m_lo, m_hi, valid):
        row_offset = (jax.lax.axis_index(INDEX_AXIS) * nb_local).astype(jnp.int32)
        bucket, mask = probe.probe_mixed(
            key_lo, key_hi, m_lo, m_hi, max_probe,
            n_buckets_global=n_buckets, row_offset=row_offset,
        )
        return accumulate(c, bucket, mask, valid)

    return count


def _shard_step(mesh: Mesh, local_step, *row_specs):
    """shard_map + jit a local step over (counts, key_lo, key_hi, *rows),
    where ``rows`` are per-data-row inputs. Counts are donated."""
    step = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(_COUNTS, _KEYS, _KEYS, *row_specs),
        out_specs=(_COUNTS, _SCALAR),
    )
    return jax.jit(step, donate_argnums=(0,))


def make_sharded_step(
    mesh: Mesh, config: MapperConfig, n_buckets: int, max_probe: int, seed: int
):
    """Compile the multi-device chunk step over continuous (ragged) packing.

    Global shapes (D = data axis size):
      counts  uint32[D, n_slots]          sharded (data, index) — donated
      key_lo  uint32[n_buckets, 8]        sharded (index, None)
      key_hi  like key_lo
      packed  uint32[D, packed_words]     sharded (data, None)
      lengths uint16[D, max_reads]        sharded (data, None)
      n_bases int32[D]                    sharded (data,)
    Returns (counts', n_valid uint32[D]).
    """
    k, buf = config.k, config.buf
    count = _local_counter(mesh, config, n_buckets, max_probe)

    def local_step(counts, key_lo, key_hi, packed, lengths, n_bases):
        lo, hi = hashing.rolling_kmer_hash_packed(packed[0], k)
        lengths_i = lengths[0].astype(jnp.int32)
        starts = jnp.cumsum(lengths_i) - lengths_i
        valid = hashing.window_mask(starts, n_bases[0], k, buf)
        c = count(counts[0], key_lo, key_hi, *feistel_mix(lo, hi, seed=seed, xp=jnp), valid)
        if config.revcomp:
            rlo, rhi = hashing.revcomp_lo_hi(lo, hi, k)
            c = count(c, key_lo, key_hi, *feistel_mix(rlo, rhi, seed=seed, xp=jnp), valid)
        return c[None], jnp.sum(valid.astype(jnp.uint32))[None]

    return _shard_step(mesh, local_step, _ROW, _ROW, _SCALAR)


def make_sharded_plane_step(
    mesh: Mesh, config: MapperConfig, n_buckets: int, max_probe: int, seed: int
):
    """Multi-device twin of ``models.mapper.plane_chunk_step``: word-plane
    hashing over stride-padded fixed-read-length packing.

    Global shapes: packed uint32[D, rows*npr] sharded (data, None), n_reads
    int32[D] sharded (data,); counts/key shards as in ``make_sharded_step``.
    """
    assert config.read_len
    k, L = config.k, config.read_len
    count = _local_counter(mesh, config, n_buckets, max_probe)

    def local_step(counts, key_lo, key_hi, packed, n_reads):
        m_lo, m_hi = hashing.plane_hash_mixed(
            packed[0], k, L, n_reads[0], seed, revcomp=config.revcomp
        )
        c = count(counts[0], key_lo, key_hi, m_lo, m_hi, jnp.ones(m_lo.shape, bool))
        return c[None], (n_reads[0] * (L - k + 1)).astype(jnp.uint32)[None]

    return _shard_step(mesh, local_step, _ROW, _SCALAR)


def make_sharded_hash_step(
    mesh: Mesh, config: MapperConfig, n_buckets: int, max_probe: int, seed: int
):
    """Multi-device twin of the pre-hashed library surface
    (``KmerMapper.map_hashes`` / ``mapper.pyx:19``'s call shape): query word
    batches fan out over the data axis, each index shard counts the keys it
    owns.

    Global shapes: q_lo/q_hi uint32[D, n] + valid bool[D, n] sharded
    (data, None); counts/key shards as in ``make_sharded_step``."""
    count = _local_counter(mesh, config, n_buckets, max_probe)

    def local_step(counts, key_lo, key_hi, q_lo, q_hi, valid):
        m_lo, m_hi = feistel_mix(q_lo[0], q_hi[0], seed=seed, xp=jnp)
        c = count(counts[0], key_lo, key_hi, m_lo, m_hi, valid[0])
        return c[None], jnp.sum(valid[0].astype(jnp.uint32))[None]

    return _shard_step(mesh, local_step, _ROW, _ROW, _ROW)


def make_finalize(mesh: Mesh, max_node_id: int, max_frequency: int = 1000):
    """Compile node-count finalization: sum count shards over the data axis,
    gather per-entry kmer counts, frequency-filter, bincount by node. Entry
    arrays are sharded over all devices; XLA inserts the collectives.

    ``counts`` is the (D, n_slots) slot-order state; ``entry_slot`` indexes
    its slot axis."""

    def finalize(counts, entry_slot, entry_node, entry_frequency):
        slot_counts = jnp.sum(counts, axis=0)
        ok = entry_frequency <= jnp.uint16(max_frequency)
        w = jnp.where(ok, slot_counts[entry_slot], jnp.uint32(0))
        return jnp.zeros(max_node_id + 1, dtype=jnp.uint32).at[entry_node].add(w)

    replicated = NamedSharding(mesh, P())
    return jax.jit(finalize, out_shardings=replicated)


class ShardedKmerMapper:
    """Multi-device mapper: index table sharded over the mesh's index axis,
    chunks fanned out over the data axis. Feed batches of D packed chunk
    buffers; finalize on device with a single collective reduction."""

    def __init__(self, index: TpuKmerIndex, config: MapperConfig, mesh: Mesh):
        self.index = index
        self.config = config
        self.mesh = mesh
        self.n_data = mesh.shape[DATA_AXIS]
        table = index.table
        self.key_lo = jax.device_put(table.key_lo, NamedSharding(mesh, _KEYS))
        self.key_hi = jax.device_put(table.key_hi, NamedSharding(mesh, _KEYS))
        self.counts = jax.device_put(
            jnp.zeros((self.n_data, table.n_slots), dtype=jnp.uint32),
            NamedSharding(mesh, _COUNTS),
        )
        self._steps: dict = {}  # lazily compiled: "ragged", "plane", hash sizes
        self._stats: list = []
        self._total_kmers = 0
        self.n_invalid_bases = 0
        self._spec_row = NamedSharding(mesh, _ROW)
        self._spec_scalar = NamedSharding(mesh, _SCALAR)

    def _get_step(self, key, make, config):
        step = self._steps.get(key)
        if step is None:
            t = self.index.table
            step = self._steps[key] = make(
                self.mesh, config, t.n_buckets, t.max_probe, t.seed
            )
        return step

    def map_batch(
        self,
        packed_batch: np.ndarray,
        lengths_batch: np.ndarray,
        n_bases: np.ndarray,
        n_invalid: int = 0,
    ) -> None:
        """packed uint32[D, packed_words], lengths uint16[D, max_reads],
        n_bases int32[D]. Short final batches are padded with empty rows.
        Batches of whole ``config.read_len`` reads take the word-plane step;
        any other batch takes the ragged step (identical counts)."""
        if self.config.read_len and self._batch_is_fixed(lengths_batch, n_bases):
            self._map_batch_plane(packed_batch, n_bases)
        else:
            step = self._get_step("ragged", make_sharded_step, self.config)
            self.counts, n_valid = step(
                self.counts,
                self.key_lo,
                self.key_hi,
                jax.device_put(packed_batch, self._spec_row),
                jax.device_put(lengths_batch, self._spec_row),
                jax.device_put(n_bases, self._spec_scalar),
            )
            self._stats.append(n_valid)
        self.n_invalid_bases += n_invalid

    def _map_batch_plane(self, packed_batch, n_bases) -> None:
        # restride each row host-side (native C++ word shifts when available)
        from ..io.readers import restride_packed, strided_rows

        L = self.config.read_len
        rows = strided_rows(self.config.buf, L)
        n_reads = (np.asarray(n_bases) // L).astype(np.int32)
        strided = np.stack(
            [
                restride_packed(row, nr, L, rows)
                for row, nr in zip(np.asarray(packed_batch), n_reads)
            ]
        )
        step = self._get_step("plane", make_sharded_plane_step, self.config)
        self.counts, n_valid = step(
            self.counts,
            self.key_lo,
            self.key_hi,
            jax.device_put(strided, self._spec_row),
            jax.device_put(n_reads, self._spec_scalar),
        )
        self._stats.append(n_valid)

    def map_hashes(self, kmers: np.ndarray) -> None:
        """Count a batch of pre-hashed uint64 kmers — the KAGE library call
        shape (``kmer_mapper/mapper.pyx:19``) on a SHARDED index: the batch
        splits over the data axis, every index shard counts the keys it owns.
        Multi-GB indexes that need ``--index-parallel`` get the same
        pre-hashed surface as the single-device ``KmerMapper.map_hashes``.

        Batches are padded to a power of two so repeated calls reuse a few
        compiled steps."""
        from ..ops.u32hash import split_u64

        kmers = np.asarray(kmers, dtype=np.uint64)
        n = len(kmers)
        if n == 0:
            return
        lo, hi = split_u64(kmers)
        D = self.n_data
        npad = 1 << max(0, (max(n, D) - 1)).bit_length()
        per = npad // D
        step = self._get_step(("hash", per), make_sharded_hash_step, self.config)
        valid = np.arange(npad) < n
        self.counts, n_valid = step(
            self.counts,
            self.key_lo,
            self.key_hi,
            jax.device_put(np.pad(lo, (0, npad - n)).reshape(D, per), self._spec_row),
            jax.device_put(np.pad(hi, (0, npad - n)).reshape(D, per), self._spec_row),
            jax.device_put(valid.reshape(D, per), self._spec_row),
        )
        self._stats.append(n_valid)  # [D] per-row valid counts; sums to n

    def _batch_is_fixed(self, lengths_batch, n_bases) -> bool:
        """Every row is whole reads of config.read_len (empty rows allowed)."""
        return all(
            chunk_is_fixed(ln, nb, self.config.read_len)
            for ln, nb in zip(np.asarray(lengths_batch), np.asarray(n_bases))
        )

    @property
    def n_kmers_mapped(self) -> int:
        if self._stats:
            fetched = jax.device_get(jnp.stack(self._stats))
            self._total_kmers += int(np.asarray(fetched, dtype=np.uint64).sum())
            self._stats = []
        return self._total_kmers

    def save_state(self, path) -> None:
        """Checkpoint the accumulated count shards + totals (resume long
        multi-device runs; mirrors ``KmerMapper.save_state``)."""
        np.savez(
            path,
            counts=np.asarray(jax.device_get(self.counts)),
            n_kmers=np.int64(self.n_kmers_mapped),
            n_invalid=np.int64(self.n_invalid_bases),
        )

    def load_state(self, path) -> None:
        with np.load(path, allow_pickle=False) as data:
            counts = data["counts"]
            if counts.shape != (self.n_data, self.index.table.n_slots):
                raise ValueError(
                    f"checkpoint counts shape {counts.shape} does not match "
                    f"mesh ({self.n_data}, {self.index.table.n_slots})"
                )
            self.counts = jax.device_put(
                counts.astype(np.uint32), NamedSharding(self.mesh, _COUNTS)
            )
            self._stats = []
            self._total_kmers = int(data["n_kmers"])
            self.n_invalid_bases = int(data["n_invalid"])

    def node_counts(self, max_frequency: int = 1000) -> np.ndarray:
        finalize = make_finalize(self.mesh, self.index.max_node_id, max_frequency)
        # pad entry arrays to a multiple of the device count for even sharding
        n_dev = self.mesh.size
        n = len(self.index.entry_slot)
        pad = (-n) % n_dev
        slot = np.pad(self.index.entry_slot, (0, pad))
        node = np.pad(self.index.entry_node, (0, pad))
        # padding entries point at node 0 but are masked by frequency = max
        freq = np.pad(self.index.entry_frequency, (0, pad), constant_values=0xFFFF)
        shard1d = NamedSharding(self.mesh, P((DATA_AXIS, INDEX_AXIS)))
        out = finalize(
            self.counts,
            jax.device_put(slot, shard1d),
            jax.device_put(node, shard1d),
            jax.device_put(freq, shard1d),
        )
        return np.asarray(jax.device_get(out))


def batch_packed_chunks(packed_iter, n_data: int, packed_words: int, max_reads: int):
    """Group single-chunk packed buffers into [D, ...] batches, padding the tail.
    Yields (packed[D, W], lengths[D, R], n_bases[D], n_invalid_total)."""
    batch = []
    for item in packed_iter:
        batch.append(item)
        if len(batch) == n_data:
            yield _stack_batch(batch, packed_words, max_reads, n_data)
            batch = []
    if batch:
        yield _stack_batch(batch, packed_words, max_reads, n_data)


def _stack_batch(batch, packed_words, max_reads, n_data):
    packed_b = np.zeros((n_data, packed_words), dtype=np.uint32)
    lengths_b = np.zeros((n_data, max_reads), dtype=np.uint16)
    n_bases = np.zeros(n_data, dtype=np.int32)
    n_invalid = 0
    for i, (p, ln, nb, _, inv) in enumerate(batch):
        packed_b[i], lengths_b[i], n_bases[i] = p, ln, nb
        n_invalid += inv
    return packed_b, lengths_b, n_bases, n_invalid

"""The flagship model: the end-to-end jittable k-mer mapping step.

One ``step`` consumes a fixed-shape chunk of framed reads (2-bit packed codes
+ uint16 read lengths) and folds its k-mer hits into the persistent per-slot
count state, entirely on device:

    packed codes -> rolling (lo, hi) hash [-> revcomp hash]
                 -> window mask (ragged reads) -> gather probe + count

Fixed-length reads (the Illumina case) take one of two equivalent
formulations: the read_len slice step (``chunk_step`` with
``MapperConfig.read_len``) over continuous packing, or the word-plane step
(``plane_chunk_step``) over stride-padded packing, which the pipeline uses.

The table ("weights") and the counts ("optimizer state") are device-resident;
the count buffer is donated so accumulation is in-place. All shapes are static,
so the step compiles once per run, and nothing in the hot loop synchronizes
with the host — per-chunk statistics are tiny device scalars fetched only at
finalization. This is the XLA analog of the reference's per-chunk worker
``map_cpu`` (``kmer_mapper/command_line_interface.py:32-56``) and GPU loop
``map_gpu`` (``:59-79``).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..index.kmer_index import TpuKmerIndex
from ..ops import encode, hashing, probe
from ..ops.u32hash import feistel_mix


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    """Static (compile-time) configuration of the mapping step."""

    k: int = 31
    buf: int = 1 << 21  # chunk capacity in bases; multiple of 16
    max_reads: int = 1 << 15  # max reads per chunk
    revcomp: bool = False  # also count reverse complements (GPU-path -r flag)
    accumulate: str = "scatter"  # count accumulator (see ops.probe)
    super_batch: int = 1  # chunks folded into one dispatch (lax.scan)
    read_len: int = 0  # all reads have exactly this length (0 = ragged). With
    # fixed-length reads (the Illumina case) the k-1 invalid windows per read
    # form a static pattern, so the dead window slots are sliced away (or
    # never formed, on the plane step) instead of being masked — no
    # window_mask, no per-read cumsum. KmerMapper verifies each chunk and
    # falls back to the ragged step when a chunk does not match.

    def __post_init__(self):
        assert 1 <= self.k <= 31
        assert self.buf % encode.BASES_PER_WORD == 0
        assert self.accumulate in probe.ACCUMULATORS
        assert self.super_batch >= 1
        if self.read_len:
            assert self.k <= self.read_len <= self.buf
            assert self.super_batch == 1, "read_len requires super_batch == 1"

    @property
    def packed_words(self) -> int:
        # buf bases plus up to 31 bases of window tail padding
        return self.buf // encode.BASES_PER_WORD + 2


def _count(counts, key_lo, key_hi, m_lo, m_hi, valid, config, max_probe):
    """Probe mixed query words and fold the hits into ``counts``."""
    bucket, mask = probe.probe_mixed(key_lo, key_hi, m_lo, m_hi, max_probe)
    return probe.ACCUMULATORS[config.accumulate](counts, bucket, mask, valid)


def chunk_step(
    key_lo: jnp.ndarray,  # uint32[n_buckets, BUCKET_KEYS]
    key_hi: jnp.ndarray,
    counts: jnp.ndarray,  # uint32[n_slots] slot order — donated
    packed: jnp.ndarray,  # uint32[packed_words] 2-bit codes
    lengths: jnp.ndarray,  # uint16[max_reads]; padding entries are 0
    n_bases: jnp.ndarray,  # int32 scalar
    *,
    config: MapperConfig,
    max_probe: int,
    seed: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (counts', n_valid_windows uint32)."""
    k, buf = config.k, config.buf
    lo, hi = hashing.rolling_kmer_hash_packed(packed, k)  # buf windows exactly
    if config.read_len:
        # fixed-length reads at stride L: valid windows are a static pattern
        # (the first L-k+1 of each read's L positions) — slice them out
        L = config.read_len
        R, W = buf // L, L - k + 1
        n_reads = n_bases // jnp.int32(L)
        lo = lo[: R * L].reshape(R, L)[:, :W].reshape(R * W)
        hi = hi[: R * L].reshape(R, L)[:, :W].reshape(R * W)
        valid = (
            lax.broadcasted_iota(jnp.int32, (R, W), 0) < n_reads
        ).reshape(R * W)
        n_valid = (n_reads * W).astype(jnp.uint32)
    else:
        lengths = lengths.astype(jnp.int32)
        starts = jnp.cumsum(lengths) - lengths  # exclusive prefix sum
        valid = hashing.window_mask(starts, n_bases, k, buf)
        n_valid = jnp.sum(valid.astype(jnp.uint32))
    counts = _count(
        counts, key_lo, key_hi, *feistel_mix(lo, hi, seed=seed, xp=jnp), valid,
        config, max_probe,
    )
    if config.revcomp:
        rlo, rhi = hashing.revcomp_lo_hi(lo, hi, k)
        counts = _count(
            counts, key_lo, key_hi, *feistel_mix(rlo, rhi, seed=seed, xp=jnp),
            valid, config, max_probe,
        )
    return counts, n_valid


def plane_chunk_step(
    key_lo: jnp.ndarray,
    key_hi: jnp.ndarray,
    counts: jnp.ndarray,  # donated
    packed: jnp.ndarray,  # uint32[rows * stride/16], STRIDE-padded reads
    n_reads: jnp.ndarray,  # int32 scalar
    *,
    config: MapperConfig,
    max_probe: int,
    seed: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Fixed-read-length step over stride-padded packing.

    Replaces ``chunk_step``'s rolling hash + window slice with
    ``hashing.plane_hash_mixed`` (contiguous word-plane shift/ORs) when the
    chunk was packed with ``pack_for_device(..., read_len=L)``. Returns
    (counts', n_valid)."""
    assert config.read_len
    m_lo, m_hi = hashing.plane_hash_mixed(
        packed, config.k, config.read_len, n_reads, seed, revcomp=config.revcomp
    )
    # invalid rows carry the sentinel pattern, which the probe never matches
    counts = _count(
        counts, key_lo, key_hi, m_lo, m_hi, jnp.ones(m_lo.shape, bool),
        config, max_probe,
    )
    W = config.read_len - config.k + 1
    return counts, (n_reads * W).astype(jnp.uint32)


def hash_step(
    key_lo, key_hi, counts, q_lo, q_hi, valid, *, config, max_probe, seed
) -> jnp.ndarray:
    """Count a batch of pre-hashed raw kmer words (``valid`` masks padding)."""
    return _count(
        counts, key_lo, key_hi, *feistel_mix(q_lo, q_hi, seed=seed, xp=jnp),
        valid, config, max_probe,
    )


def make_plane_step(config: MapperConfig, max_probe: int, seed: int):
    """Compile the stride-packed fixed-read-length step (counts donated)."""
    fn = functools.partial(
        plane_chunk_step, config=config, max_probe=max_probe, seed=seed
    )
    return jax.jit(fn, donate_argnums=(2,))


def make_step(config: MapperConfig, max_probe: int, seed: int):
    """Compile the chunk step; count state donated for in-place accumulation.

    With ``config.super_batch > 1`` the step takes stacked inputs
    (packed[S, W], lengths[S, R], n_bases[S]) and scans the per-chunk step
    inside one executable, returning per-chunk n_valid[S]."""
    fn = functools.partial(chunk_step, config=config, max_probe=max_probe, seed=seed)
    if config.super_batch == 1:
        return jax.jit(fn, donate_argnums=(2,))

    def scanned(key_lo, key_hi, counts, packed_s, lengths_s, n_bases_s):
        def body(counts, xs):
            packed, lengths, n_bases = xs
            counts, n_valid = fn(key_lo, key_hi, counts, packed, lengths, n_bases)
            return counts, n_valid

        return jax.lax.scan(body, counts, (packed_s, lengths_s, n_bases_s))

    return jax.jit(scanned, donate_argnums=(2,))


def chunk_is_fixed(lengths, n_bases, read_len: int) -> bool:
    """True iff the chunk is exactly n whole reads of ``read_len`` (so the
    fixed-stride window slicing in chunk_step is valid). Shared by the
    single-device and sharded mappers' fast-path checks."""
    nb = int(n_bases)
    if nb % read_len:
        return False
    n = nb // read_len
    lengths = np.asarray(lengths)
    return bool(np.all(lengths[:n] == read_len)) and not np.any(lengths[n:])


def default_config(**kwargs) -> MapperConfig:
    """MapperConfig with the production defaults, the same on every backend
    (super_batch stays 1: the scanned multi-chunk dispatch is not measured
    on the GPU)."""
    return MapperConfig(**kwargs)


class KmerMapper:
    """Device-resident mapper: index table on device + streaming accumulation.

    Programmatic equivalent of the reference's ``map_bnp`` inner loop; feed
    packed chunks via :meth:`map_chunk`, then :meth:`node_counts`. The feed
    path never blocks on the device (async dispatch), so host framing overlaps
    device compute.
    """

    def __init__(self, index: TpuKmerIndex, config: MapperConfig, device=None):
        self.index = index
        self.config = config
        table = index.table
        put = functools.partial(jax.device_put, device=device)
        self.key_lo = put(table.key_lo)
        self.key_hi = put(table.key_hi)
        self.counts = put(jnp.zeros(table.n_slots, dtype=jnp.uint32))
        self._step = make_step(config, table.max_probe, table.seed)
        # stride-packed fast step (pack_for_device(read_len=L) buffers); jit
        # is lazy so this compiles only if strided chunks actually arrive
        self._plane_step = (
            make_plane_step(config, table.max_probe, table.seed)
            if config.read_len
            else None
        )
        self._ragged_step = None  # lazy twin for chunks that break read_len
        self._stats: list[jnp.ndarray] = []  # per-chunk n_valid device scalars
        self._pending: list = []  # host-buffered chunks awaiting a super-batch
        self._total_kmers = 0
        self.n_invalid_bases = 0
        self._device = device
        self._hash_steps: dict = {}  # padded-length -> jitted map_hashes step

    def _chunk_is_fixed(self, lengths, n_bases: int) -> bool:
        return chunk_is_fixed(lengths, n_bases, self.config.read_len)

    def reset_counts(self) -> None:
        """Zero the accumulated state so one device-resident table can serve
        repeated library calls without a rebuild (KAGE calls
        ``map_kmers_to_graph_index`` per batch, ``mapper.pyx:19``)."""
        self.flush()
        self.counts = jax.device_put(
            jnp.zeros(self.index.table.n_slots, dtype=jnp.uint32), device=self._device
        )
        self._stats = []
        self._total_kmers = 0
        self.n_invalid_bases = 0

    def map_chunk(
        self,
        packed: np.ndarray,
        lengths: np.ndarray,
        n_bases: int,
        n_invalid: int = 0,
        strided: bool = False,
    ) -> None:
        """Fold one packed chunk into the count state.

        ``strided=True`` marks a buffer packed by ``pack_for_device(...,
        read_len=L)`` with every read padded to ``hashing.read_stride(L)``
        bases (all reads exactly L long, ``n_bases`` = L * n_reads): it takes
        the word-plane step. Continuous buffers (default) take the
        rolling-hash step."""
        self.n_invalid_bases += n_invalid
        if strided:
            if self._plane_step is None:
                raise ValueError("strided chunks require config.read_len")
            n_reads = n_bases // self.config.read_len
            self.counts, n_valid = self._plane_step(
                self.key_lo,
                self.key_hi,
                self.counts,
                jnp.asarray(packed),
                jnp.int32(n_reads),
            )
            self._stats.append(n_valid)
            return
        if self.config.super_batch == 1:
            step = self._step
            if self.config.read_len and not self._chunk_is_fixed(lengths, n_bases):
                # a chunk with off-length reads (mixed-length file, split long
                # reads, ...) takes the ragged step; results are identical
                if self._ragged_step is None:
                    cfg = dataclasses.replace(self.config, read_len=0)
                    table = self.index.table
                    self._ragged_step = make_step(cfg, table.max_probe, table.seed)
                step = self._ragged_step
            self.counts, n_valid = step(
                self.key_lo,
                self.key_hi,
                self.counts,
                jnp.asarray(packed),
                jnp.asarray(lengths),
                jnp.int32(n_bases),
            )
            self._stats.append(n_valid)
            return
        self._pending.append((packed, lengths, np.int32(n_bases)))
        if len(self._pending) == self.config.super_batch:
            self._dispatch_pending()

    def _dispatch_pending(self) -> None:
        if not self._pending:
            return
        s = self.config.super_batch
        packed_s = np.zeros((s, self.config.packed_words), dtype=np.uint32)
        lengths_s = np.zeros((s, self.config.max_reads), dtype=np.uint16)
        n_bases_s = np.zeros(s, dtype=np.int32)
        for i, (p, ln, nb) in enumerate(self._pending):
            packed_s[i], lengths_s[i], n_bases_s[i] = p, ln, nb
        self._pending = []
        self.counts, n_valid = self._step(
            self.key_lo,
            self.key_hi,
            self.counts,
            jnp.asarray(packed_s),
            jnp.asarray(lengths_s),
            jnp.asarray(n_bases_s),
        )
        self._stats.append(jnp.sum(n_valid))

    def flush(self) -> None:
        """Dispatch any buffered sub-batch (padded with empty chunks)."""
        self._dispatch_pending()

    @property
    def n_kmers_mapped(self) -> int:
        self.flush()
        if self._stats:
            # one stacked transfer instead of a fetch per scalar
            fetched = jax.device_get(jnp.stack(self._stats))
            self._total_kmers += int(np.asarray(fetched, dtype=np.uint64).sum())
            self._stats = []
        return self._total_kmers

    def map_hashes(self, kmers: np.ndarray) -> None:
        """Count pre-computed uint64 kmer hashes (library API parity with
        ``map_kmers_to_graph_index`` / ``counter.count``).

        Lengths are padded to powers of two so repeated calls reuse a few
        compiled steps."""
        from ..ops.u32hash import split_u64

        kmers = np.asarray(kmers, dtype=np.uint64)
        n = len(kmers)
        if n == 0:
            return
        lo, hi = split_u64(kmers)
        npad = 1 << (n - 1).bit_length()
        step = self._hash_steps.get(npad)
        if step is None:
            table = self.index.table
            step = self._hash_steps[npad] = jax.jit(
                functools.partial(
                    hash_step, config=self.config, max_probe=table.max_probe,
                    seed=table.seed,
                ),
                donate_argnums=(2,),
            )
        self.counts = step(
            self.key_lo,
            self.key_hi,
            self.counts,
            jnp.asarray(np.pad(lo, (0, npad - n))),
            jnp.asarray(np.pad(hi, (0, npad - n))),
            jnp.asarray(np.arange(npad) < n),
        )
        self._stats.append(jnp.uint32(n))

    def in_index(self, kmers: np.ndarray) -> np.ndarray:
        """Membership per uint64 kmer hash, uint8[n] (no frequency filter) —
        parity with the reference's ``in_graph_index``
        (``kmer_mapper/mapper.pyx:81-130``), on device."""
        from ..ops.u32hash import split_u64

        lo, hi = split_u64(np.asarray(kmers, dtype=np.uint64))
        table = self.index.table
        slots = probe.probe_slots(
            self.key_lo,
            self.key_hi,
            jnp.asarray(lo),
            jnp.asarray(hi),
            table.max_probe,
            table.seed,
        )
        return np.asarray(jax.device_get(slots >= 0)).astype(np.uint8)

    def save_state(self, path) -> None:
        """Checkpoint the accumulated counts + totals (resume long runs)."""
        np.savez(
            path,
            counts=self.slot_counts(),
            n_kmers=np.int64(self.n_kmers_mapped),
            n_invalid=np.int64(self.n_invalid_bases),
        )

    def load_state(self, path) -> None:
        with np.load(path, allow_pickle=False) as data:
            self.counts = jax.device_put(
                data["counts"].astype(np.uint32), device=self._device
            )
            self._stats = []
            self._pending = []
            self._total_kmers = int(data["n_kmers"])
            self.n_invalid_bases = int(data["n_invalid"])

    def slot_counts(self) -> np.ndarray:
        self.flush()
        return np.asarray(jax.device_get(self.counts))

    def node_counts(self, max_frequency: int = 1000) -> np.ndarray:
        """Final per-node hit counts, uint32[max_node_id + 1]."""
        return self.index.node_counts(self.slot_counts(), max_frequency=max_frequency)

    def kmer_counts(self) -> tuple[np.ndarray, np.ndarray]:
        """Counter view: (unique_kmers, counts) — CounterKmerIndex parity."""
        return self.index.kmer_counts(self.slot_counts())

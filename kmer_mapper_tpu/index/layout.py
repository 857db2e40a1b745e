"""Device table layout: block-chained bucketized hash table.

The device replacement for both of the reference's probe structures — the
CPU bucketed index scan (``kmer_mapper/mapper.pyx:53-69``) and the CUDA
``cucounter.Counter`` open-addressing table (``kmer_mapper/gpu_counter.py``).

The device probe (``ops/probe.py``) does, per probe round, one (n, 8)-uint32
row gather each from the lo- and hi-word arrays. Collision chains **wrap
around inside aligned CHAIN_BLOCK-bucket blocks**, so a chain never leaves
its block: with block-aligned shards of a sharded table, a key's whole chain
lives on one device.

Buckets hold 8 keys; slots store the BIJECTIVELY MIXED key words
(``u32hash.feistel_mix`` — 32-bit operations only, no 64-bit modulo), and the
bucket id is the high bits of the mixed low word. The empty sentinel is the
all-ones mixed pair; a key mixing to it reseeds the build (probability
~n/2^64). The default load factor keeps chains rare so the recorded
``max_probe`` stays small. Build is vectorized host numpy.
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np

from ..ops.u32hash import bucket_from_mlo, feistel_mix, split_u64

logger = logging.getLogger(__name__)

BUCKET_KEYS = 8  # keys per bucket
CHAIN_BLOCK = 128  # buckets per chain block (shard quantum; not re-measured on the GPU)
EMPTY = np.uint32(0xFFFFFFFF)
DEFAULT_MAX_LOAD = 0.5  # table load factor (not re-measured on the GPU)
MAX_PROBE_LIMIT = 8  # default chain bound: rebuild bigger if a chain would
# exceed this. The gather probe runs max_probe rounds for every query, so
# the bound is also its cost; denser tables built with a higher
# ``max_probe_limit`` stay valid. MAX_PROBE_HARD bounds any loadable table.
MAX_PROBE_HARD = 64


@dataclasses.dataclass
class TableArrays:
    """Host-side arrays of the table (moved to device verbatim).

    Slots store the **bijectively mixed** key words (``u32hash.feistel_mix``),
    not the raw kmer: equality of mixed words is equality of kmers, the bucket
    id is ``key_lo >> bucket_shift(n_buckets)``. ``key_words``/``kmer
    view`` callers unmix on the host."""

    key_lo: np.ndarray  # uint32[n_buckets, BUCKET_KEYS] (mixed)
    key_hi: np.ndarray  # uint32[n_buckets, BUCKET_KEYS] (mixed)
    n_buckets: int
    max_probe: int  # buckets a query must examine (chain bound)
    seed: int = 0
    # global slot of each key passed to build_table, in input order (build
    # byproduct: avoids re-probing every entry at index construction; not
    # serialized — reload paths recompute what they need)
    build_slots: np.ndarray | None = dataclasses.field(default=None, repr=False)

    @property
    def n_slots(self) -> int:
        return self.n_buckets * BUCKET_KEYS

    @property
    def nbytes(self) -> int:
        return self.key_lo.nbytes + self.key_hi.nbytes

    def key_words(self) -> tuple[np.ndarray, np.ndarray]:
        """(m_lo, m_hi) MIXED uint32[n_slots] in slot order (bucket-major);
        ``u32hash.feistel_unmix`` recovers the raw kmer words."""
        return self.key_lo.reshape(-1), self.key_hi.reshape(-1)


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


def chain_next(b: np.ndarray, step: int, n_buckets: int):
    """Bucket ``step`` positions down the chain: wraps inside the aligned
    CHAIN_BLOCK-bucket block containing ``b`` (and inside the table if it is
    smaller than one block)."""
    block = min(CHAIN_BLOCK, n_buckets)
    return (b & ~(block - 1)) | ((b + step) & (block - 1))


def build_table(
    unique_kmers: np.ndarray,
    max_load: float = DEFAULT_MAX_LOAD,
    seed: int = 0,
    n_buckets: int | None = None,
    max_probe_limit: int = MAX_PROBE_LIMIT,
) -> TableArrays:
    """Build the table from distinct uint64 kmers. Vectorized; O(n log n).

    Keys whose MIXED words equal the EMPTY sentinel (probability ~n/2^64 —
    the mix is a bijection over the full 64-bit space) trigger a reseeded
    rebuild via the retry loop, so every input key is representable."""
    unique_kmers = np.asarray(unique_kmers, dtype=np.uint64)
    n = len(unique_kmers)
    if n_buckets is None:
        n_buckets = max(4, _next_pow2(int(np.ceil(n / (BUCKET_KEYS * max_load))) or 1))
    grew = 0
    for attempt in range(8):
        table = _try_build(unique_kmers, n_buckets, seed, max_probe_limit)
        if table == "sentinel":
            seed += 13  # reseed only: a sentinel hit needs no more memory
            continue
        if table is not None:
            if grew:
                logger.info("table build grew %d time(s) to bound chains", grew)
            return table
        n_buckets *= 2
        seed += 13
        grew += 1
    raise RuntimeError("table build failed to bound probe chains")


def _try_build(keys: np.ndarray, n_buckets: int, seed: int,
               max_probe_limit: int = MAX_PROBE_LIMIT):
    n = len(keys)
    if max_probe_limit < 1:
        return None
    lo, hi = feistel_mix(*split_u64(keys), seed=seed)
    if n and np.any((lo == EMPTY) & (hi == EMPTY)):
        return "sentinel"  # mixed key equals the empty-slot sentinel: reseed
    b = bucket_from_mlo(lo, n_buckets).astype(np.int64)

    key_lo = np.full((n_buckets, BUCKET_KEYS), EMPTY, dtype=np.uint32)
    key_hi = np.full((n_buckets, BUCKET_KEYS), EMPTY, dtype=np.uint32)
    filled = np.zeros(n_buckets, dtype=np.int64)
    slots = np.empty(n, dtype=np.int64)

    # Round 1 handles ~all keys (later rounds only place chain spill, a few
    # permille at the default load), so it gets a table-is-empty fast path:
    # int32 radix argsort (bucket ids are < 2^31; 2.5x the int64 sort),
    # run-start ranks via one maximum.accumulate instead of a bisection, a
    # scalar capacity test (every bucket has all BUCKET_KEYS slots free), and
    # the filled[] update as per-run minimums instead of np.add.at (which is
    # ~0.7 us/element). Slot assignment is BIT-IDENTICAL to the general
    # branch below (same stable order); tests pin the two against each other.
    if n:
        order = np.argsort(b.astype(np.int32), kind="stable")
        sb = b[order]
        idx = np.arange(n, dtype=np.int64)
        is_start = np.empty(n, dtype=bool)
        is_start[0] = True
        np.not_equal(sb[1:], sb[:-1], out=is_start[1:])
        rank = idx - np.maximum.accumulate(np.where(is_start, idx, 0))
        place = rank < BUCKET_KEYS
        flat = sb[place] * BUCKET_KEYS + rank[place]
        p_placed = order[place]
        key_lo.reshape(-1)[flat] = lo[p_placed]
        key_hi.reshape(-1)[flat] = hi[p_placed]
        slots[p_placed] = flat
        starts = np.flatnonzero(is_start)
        run_len = np.diff(np.append(starts, n))
        filled[sb[starts]] = np.minimum(run_len, BUCKET_KEYS)
        pending = order[~place]
        if len(pending):
            b[pending] = chain_next(b[pending], 1, n_buckets)
    else:
        pending = np.arange(0, dtype=np.int64)

    probe = 1 if len(pending) else 0
    while len(pending):
        if probe >= max_probe_limit:
            return None
        order = np.argsort(b[pending], kind="stable")
        p = pending[order]
        sb = b[p]
        first = np.searchsorted(sb, sb, side="left")
        rank = np.arange(len(p), dtype=np.int64) - first
        avail = BUCKET_KEYS - filled[sb]
        place = rank < avail
        pb, pr = sb[place], (filled[sb] + rank)[place]
        key_lo[pb, pr] = lo[p[place]]
        key_hi[pb, pr] = hi[p[place]]
        slots[p[place]] = pb * BUCKET_KEYS + pr
        np.add.at(filled, pb, 1)
        pending = p[~place]
        if len(pending):
            b[pending] = chain_next(b[pending], 1, n_buckets)
            probe += 1
    return TableArrays(
        key_lo=key_lo, key_hi=key_hi, n_buckets=n_buckets, max_probe=probe + 1,
        seed=seed, build_slots=slots,
    )


def query_table(table: TableArrays, kmers: np.ndarray) -> np.ndarray:
    """Host/oracle query: global slot id (bucket * BUCKET_KEYS + lane) of each
    kmer, or -1 if absent. Bit-identical semantics to both device probes."""
    kmers = np.asarray(kmers, dtype=np.uint64)
    lo, hi = feistel_mix(*split_u64(kmers), seed=table.seed)
    # a query whose mixed words equal the sentinel can only "match" empty
    # slots (the build reseeds if an index key mixes to it) — mask it
    real = ~((lo == EMPTY) & (hi == EMPTY))
    b0 = bucket_from_mlo(lo, table.n_buckets).astype(np.int64)
    out = np.full(len(kmers), -1, dtype=np.int64)
    for p in range(table.max_probe):
        b = chain_next(b0, p, table.n_buckets)
        match = (table.key_lo[b] == lo[:, None]) & (table.key_hi[b] == hi[:, None])
        any_match = match.any(axis=1) & real
        lane = match.argmax(axis=1)
        out = np.where((out < 0) & any_match, b * BUCKET_KEYS + lane, out)
    return out

"""Device-side gather probe and count accumulation (XLA path).

The accelerator counterpart of the reference's hot kernels (Cython bucket
scan, ``kmer_mapper/mapper.pyx:53-69``; CUDA ``cucounter`` atomic counter,
``kmer_mapper/gpu_counter.py:23-24``), probing the block-chained layout of
``index/layout.py`` with per-round row gathers. Every device path — the
single-device and sharded chunk steps, the fixed-read-length plane step, and
pre-hashed queries — counts through this module.

Counting: the accumulator is a scatter-add into the flat slot-order count
vector (``scatter`` with duplicate indices, which XLA lowers to atomic adds
on the GPU as cucounter does by hand; or ``sorted``: sort + run-length
encode + unique-index scatter).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..index.layout import BUCKET_KEYS, CHAIN_BLOCK
from .u32hash import bucket_shift, feistel_mix


def chain_next(b: jnp.ndarray, step: int, n_buckets: int) -> jnp.ndarray:
    """jnp twin of ``layout.chain_next`` (wrap inside aligned chain blocks)."""
    block = min(CHAIN_BLOCK, n_buckets)
    return (b & ~jnp.int32(block - 1)) | ((b + step) & jnp.int32(block - 1))


def probe_mixed(
    key_lo: jnp.ndarray,  # uint32[n_local_buckets, BUCKET_KEYS]
    key_hi: jnp.ndarray,
    m_lo: jnp.ndarray,  # uint32[n] query words already through feistel_mix
    m_hi: jnp.ndarray,
    max_probe: int,
    n_buckets_global: int | None = None,
    row_offset=0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(bucket int32[n] local bucket id or 0, mask uint32[n, BUCKET_KEYS]).

    ``mask`` is the per-lane one-hot hit indicator (all-zero for misses or for
    queries owned by another shard). Single-device: the table arrays hold all
    buckets. Sharded: the shard owns buckets [row_offset, row_offset +
    n_local); bucket ids are computed against the global bucket count and
    out-of-range rows are masked, so a key is counted only by the shard that
    stores it.

    A query whose mixed words are the all-ones empty-slot sentinel is no
    query: it can only "match" empty slots (the build reseeds away real keys
    that mix to it), so it never hits. The plane step marks its padding rows
    this way."""
    n_local = key_lo.shape[0]
    if n_buckets_global is None:
        n_buckets_global = n_local
    real = ~((m_lo == jnp.uint32(0xFFFFFFFF)) & (m_hi == jnp.uint32(0xFFFFFFFF)))
    shift = bucket_shift(n_buckets_global)
    b0 = (m_lo >> jnp.uint32(shift)).astype(jnp.int32) if shift < 32 else (
        jnp.zeros(m_lo.shape, jnp.int32)
    )
    bucket = jnp.zeros(m_lo.shape, dtype=jnp.int32)
    mask = jnp.zeros((m_lo.shape[0], BUCKET_KEYS), dtype=bool)
    for p in range(max_probe):
        b_g = chain_next(b0, p, n_buckets_global)
        b_l = b_g - row_offset
        in_range = (b_l >= 0) & (b_l < n_local) & real
        b_safe = jnp.where(in_range, b_l, 0)
        kl = key_lo[b_safe]  # (n, BUCKET_KEYS) row gather
        kh = key_hi[b_safe]
        m = (kl == m_lo[:, None]) & (kh == m_hi[:, None]) & in_range[:, None]
        hit = m.any(axis=1)
        # keys are unique in the table: at most one (bucket, lane) matches
        bucket = jnp.where(hit, b_safe, bucket)
        mask = mask | m
    return bucket, mask.astype(jnp.uint32)


def probe_hits(
    key_lo: jnp.ndarray,
    key_hi: jnp.ndarray,
    q_lo: jnp.ndarray,  # uint32[n] raw kmer words
    q_hi: jnp.ndarray,
    max_probe: int,
    seed: int,
    n_buckets_global: int | None = None,
    row_offset=0,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """:func:`probe_mixed` for raw (unmixed) query words."""
    m_lo, m_hi = feistel_mix(q_lo, q_hi, seed=seed, xp=jnp)
    return probe_mixed(
        key_lo, key_hi, m_lo, m_hi, max_probe, n_buckets_global, row_offset
    )


def probe_slots(
    key_lo: jnp.ndarray,
    key_hi: jnp.ndarray,
    q_lo: jnp.ndarray,
    q_hi: jnp.ndarray,
    max_probe: int,
    seed: int,
    n_buckets_global: int | None = None,
    row_offset=0,
) -> jnp.ndarray:
    """Local table slot (bucket * BUCKET_KEYS + lane) per query, or -1."""
    bucket, mask = probe_hits(
        key_lo, key_hi, q_lo, q_hi, max_probe, seed, n_buckets_global, row_offset
    )
    any_hit = mask.any(axis=1)
    lane = jnp.argmax(mask, axis=1).astype(jnp.int32)
    return jnp.where(any_hit, bucket * BUCKET_KEYS + lane, -1)


# --- count accumulation ------------------------------------------------------
# counts are uint32[n_slots] flat in slot order (slot = bucket * BUCKET_KEYS +
# lane); misses and invalid queries index past the end and are dropped.


def _hit_index(counts, bucket, mask, valid):
    any_hit = mask.any(axis=1) & valid
    lane = jnp.argmax(mask, axis=1).astype(jnp.int32)
    return jnp.where(any_hit, bucket * BUCKET_KEYS + lane, counts.shape[0])


def accumulate_scatter(counts, bucket, mask, valid):
    """Element scatter-add with duplicate indices."""
    idx = _hit_index(counts, bucket, mask, valid)
    return counts.at[idx].add(jnp.uint32(1), mode="drop")


def accumulate_sorted(counts, bucket, mask, valid):
    """Sort + run-length-encode + unique-index scatter."""
    n_slots = counts.shape[0]
    idx = _hit_index(counts, bucket, mask, valid)
    n = idx.shape[0]
    s = jnp.sort(idx)
    first = jnp.concatenate([jnp.ones(1, dtype=bool), s[1:] != s[:-1]])
    seg = jnp.cumsum(first.astype(jnp.int32)) - 1
    run_len = jax.ops.segment_sum(
        jnp.ones(n, dtype=jnp.uint32), seg, num_segments=n, indices_are_sorted=True
    )
    len_here = run_len[seg]
    target = jnp.where(first & (s < n_slots), s, n_slots)
    return counts.at[target].add(jnp.where(first, len_here, 0), mode="drop")


ACCUMULATORS = {"scatter": accumulate_scatter, "sorted": accumulate_sorted}

"""32-bit hash mixing shared by the host-side table builder (numpy) and the
device-side probe (jax.numpy).

The framework represents k-mers as (lo, hi) uint32 word pairs everywhere on
device, so device code runs in JAX's default 32-bit mode. Bucket selection
for the open-addressing table needs a well-avalanched hash of the 64-bit kmer
computed from those two words using only 32-bit ops
(xor/shift/wraparound-multiply), which numpy and XLA execute identically.
This replaces the reference's ``kmer % modulo`` bucket function
(``kmer_mapper/mapper.pyx:54``) — the modulo was an artifact of the
reference's index layout; a power-of-two table with a strong mixer avoids
64-bit division entirely.

The mixer is a **bijective** 64-bit permutation: a 3-round Feistel network
whose round function is the murmur3 finalizer (fmix32). Bijectivity is what
lets the table store the MIXED words (m_lo, m_hi) instead of the raw kmer —
equality of mixed words is equality of kmers, and the bucket is simply the
high bits of m_lo. ``feistel_unmix`` recovers raw kmers from stored table
words on the host.
"""
from __future__ import annotations

import numpy as np

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
#: Feistel round constants (arbitrary odd words; one per round)
_FEISTEL_ROUNDS = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35)


def fmix32(x, xp=np):
    """murmur3 finalizer; ``x`` must be a uint32 array of the given namespace."""
    u = xp.uint32
    if xp is np and isinstance(x, np.ndarray) and x.size > 1024:
        # allocation-lean host path (same arithmetic bit-for-bit): the naive
        # expression chain allocates 5 full temporaries, which dominates the
        # index build's mix stage at tens of millions of keys
        y = x >> np.uint32(16)
        np.bitwise_xor(x, y, out=y)
        np.multiply(y, np.uint32(_C1), out=y)
        t = y >> np.uint32(13)
        np.bitwise_xor(y, t, out=t)
        np.multiply(t, np.uint32(_C2), out=t)
        np.right_shift(t, np.uint32(16), out=y)
        np.bitwise_xor(t, y, out=y)
        return y
    x = x ^ (x >> u(16))
    x = x * u(_C1)
    x = x ^ (x >> u(13))
    x = x * u(_C2)
    x = x ^ (x >> u(16))
    return x


def feistel_mix(lo, hi, seed: int = 0, xp=np):
    """Bijective 64-bit mix of (lo, hi) -> (m_lo, m_hi), 32-bit ops only.

    3 Feistel rounds, round function fmix32(. ^ round_const ^ seed). The
    output low word is fully avalanched in both input words; the permutation
    is invertible by :func:`feistel_unmix` for any seed."""
    u = xp.uint32
    L, R = lo, hi
    for c in _FEISTEL_ROUNDS:
        k = u(np.uint32((c + seed) & 0xFFFFFFFF))
        L, R = R, L ^ fmix32(R ^ k, xp=xp)
    return L, R


def feistel_unmix(m_lo, m_hi, seed: int = 0, xp=np):
    """Inverse of :func:`feistel_mix` (host-side: counter views, debugging)."""
    u = xp.uint32
    L, R = m_lo, m_hi
    for c in reversed(_FEISTEL_ROUNDS):
        k = u(np.uint32((c + seed) & 0xFFFFFFFF))
        L, R = R ^ fmix32(L ^ k, xp=xp), L
    return L, R


def mix64(lo, hi, seed: int = 0, xp=np):
    """Avalanche-mix a 64-bit value given as (lo, hi) uint32 words -> uint32."""
    u = xp.uint32
    h = fmix32(hi ^ u(np.uint32((_GOLDEN + seed) & 0xFFFFFFFF)), xp=xp)
    return fmix32(lo ^ h, xp=xp)


def bucket_shift(n_buckets: int) -> int:
    """m_lo >> bucket_shift(n) is the bucket id: buckets are the HIGH bits of
    the mixed low word."""
    assert n_buckets & (n_buckets - 1) == 0, "n_buckets must be a power of two"
    return 32 - (n_buckets - 1).bit_length() if n_buckets > 1 else 32


def bucket_from_mlo(m_lo, n_buckets: int, xp=np):
    """Bucket id from an already-mixed low word (high bits; single-bucket
    tables shift by 32, which C/XLA leave undefined — return 0 instead)."""
    shift = bucket_shift(n_buckets)
    if shift >= 32:  # single bucket
        return xp.uint32(0) * m_lo
    return m_lo >> xp.uint32(shift)


def bucket_of(lo, hi, n_buckets: int, seed: int = 0, xp=np):
    """Bucket id in [0, n_buckets); n_buckets must be a power of two."""
    return bucket_from_mlo(
        feistel_mix(lo, hi, seed=seed, xp=xp)[0], n_buckets, xp=xp
    )


def split_u64(kmers: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side: uint64 kmers -> (lo, hi) uint32 word pair."""
    k = np.asarray(kmers, dtype=np.uint64)
    lo = (k & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (k >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def join_u64(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Host-side: (lo, hi) uint32 word pair -> uint64."""
    return np.asarray(lo, dtype=np.uint64) | (np.asarray(hi, dtype=np.uint64) << np.uint64(32))

"""Device-side rolling k-mer hashing and ragged window masking.

Each k-mer hash (up to 62 bits for k<=31) is carried as a (lo, hi) uint32
word pair, so device code needs no 64-bit integers (JAX's default 32-bit
mode). The hash convention is the
reference's (first base least-significant; see ``oracle.kmer_hashes``):

    lo |= code[t+m] << 2m          for m < 16
    hi |= code[t+m] << (2m - 32)   for m >= 16

The k-term accumulation is expressed as k static shifted-slice ORs over the
whole chunk — fully vectorized elementwise work that XLA fuses with the encode gather,
replacing both bionumpy's ``get_kmers`` rolling window (``util.py:71-75``) and
the cupy variant of the GPU path.

Window validity reproduces bionumpy's ragged behavior: a window starting at t
is valid iff no read starts strictly inside (t, t+k) and t+k <= n_valid_bases —
k-mers never cross read boundaries and short reads yield none.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def rolling_kmer_hash(codes: jnp.ndarray, k: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """codes: uint32[n + k] (chunk padded by >=k) -> (lo, hi) uint32[n] where
    entry t is the hash of window [t, t+k). Caller masks invalid windows."""
    assert 1 <= k <= 31, "k must be in [1, 31] (62-bit hashes)"
    n = codes.shape[0] - k
    lo = jnp.zeros(n, dtype=jnp.uint32)
    hi = jnp.zeros(n, dtype=jnp.uint32)
    for m in range(k):
        c = codes[m : m + n]
        if 2 * m < 32:
            lo = lo | (c << 2 * m)
        else:
            hi = hi | (c << (2 * m - 32))
    return lo, hi


def rolling_kmer_hash_packed(
    packed: jnp.ndarray, k: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Rolling hashes computed directly from 2-bit packed words.

    The packed buffer is one continuous bit stream (base i occupies bits
    [2i, 2i+2) of word i//16), so window t's hash is just bits [2t, 2t+2k) —
    two word reads and shifts per window instead of k shifted-slice ORs over
    unpacked codes (~40x fewer operations at k=31). Vectorized as 16
    alignment phases over the word array.

    packed: uint32[w] (w >= 3); returns (lo, hi) uint32[(w-2)*16], entry t the
    hash of window [t, t+k). Matches ``rolling_kmer_hash`` bit-exactly."""
    assert 1 <= k <= 31
    w0 = packed[:-2]
    w1 = packed[1:-1]
    w2 = packed[2:]
    lo_mask = jnp.uint32(0xFFFFFFFF if k >= 16 else (1 << (2 * k)) - 1)
    hi_mask = jnp.uint32((1 << max(0, 2 * k - 32)) - 1)
    los, his = [], []
    for p in range(16):
        s = 2 * p
        lo = (w0 >> s) | (w1 << (32 - s)) if s else w0
        los.append(lo & lo_mask)
        if k > 16:
            hi = (w1 >> s) | (w2 << (32 - s)) if s else w1
            his.append(hi & hi_mask)
        else:
            his.append(jnp.zeros_like(w0))
    lo = jnp.stack(los, axis=1).reshape(-1)
    hi = jnp.stack(his, axis=1).reshape(-1)
    return lo, hi


#: mixed-word pattern of an invalid query slot: the table's empty-slot sentinel
INVALID_WORD = 0xFFFFFFFF


def read_stride(read_len: int) -> int:
    """Packed stride (bases) for fixed-length reads: the next multiple of 16,
    so each read starts word-aligned and owns ``read_stride // 16`` whole
    words. See :func:`plane_hash_mixed`."""
    return -(-read_len // 16) * 16


def plane_hash_mixed(
    packed: jnp.ndarray,
    k: int,
    read_len: int,
    n_reads: jnp.ndarray,  # int32 scalar: rows beyond it become invalid
    seed: int,
    revcomp: bool = False,
):
    """Mixed window hashes from stride-padded fixed-length-read packing.

    The fixed-read-length alternative to ``rolling_kmer_hash_packed`` + the
    ``(R, L)[:, :W]`` window slice + ``feistel_mix``: with each read padded to
    ``read_stride(read_len)`` bases at packing time, every valid window
    s = 16*j + p of a read lives entirely in that read's own words j..j+2
    (2*s + 2*k <= 2*read_len <= 2*stride), so the W = read_len-k+1 valid
    windows are W static (p, j) combos, each a shift/OR over contiguous
    word-plane columns of the (stride/16, R) transpose — no 16-phase
    interleave and no window slice.

    Returns (m_lo, m_hi) uint32[n_combos * R], already through
    ``feistel_mix`` for ``ops.probe.probe_mixed``. Output order is a fixed
    permutation of window order (counts do not depend on it). Rows >=
    ``n_reads`` become the all-ones sentinel pattern, which the probe treats
    as no query. With ``revcomp``, the reverse-complement hash of every
    window follows it."""
    from .u32hash import feistel_mix

    assert 1 <= k <= 31 and read_len >= k
    stride = read_stride(read_len)
    npr = stride // 16
    R = packed.shape[0] // npr
    planes = packed[: R * npr].reshape(R, npr).T  # (npr, R) contiguous planes
    zeros = jnp.zeros(R, jnp.uint32)

    def col(j):
        return planes[j] if j < npr else zeros

    lo_mask = jnp.uint32(0xFFFFFFFF if k >= 16 else (1 << (2 * k)) - 1)
    hi_mask = jnp.uint32((1 << max(0, 2 * k - 32)) - 1)
    valid_row = (
        jax.lax.broadcasted_iota(jnp.int32, (R, 1), 0).reshape(R) < n_reads
    )
    inv = jnp.uint32(INVALID_WORD)
    mlos, mhis = [], []

    def emit(lo, hi):
        m_lo, m_hi = feistel_mix(lo, hi, seed=seed, xp=jnp)
        mlos.append(jnp.where(valid_row, m_lo, inv))
        mhis.append(jnp.where(valid_row, m_hi, inv))

    for p in range(16):
        s2 = 2 * p
        for j in range(npr):
            if 16 * j + p > read_len - k:
                continue
            w0, w1, w2 = col(j), col(j + 1), col(j + 2)
            if s2:
                lo = ((w0 >> s2) | (w1 << (32 - s2))) & lo_mask
                hi = ((w1 >> s2) | (w2 << (32 - s2))) & hi_mask
            else:
                lo = w0 & lo_mask
                hi = w1 & hi_mask
            emit(lo, hi)
            if revcomp:
                emit(*revcomp_lo_hi(lo, hi, k))
    assert len(mlos) == (read_len - k + 1) * (2 if revcomp else 1)
    return jnp.concatenate(mlos), jnp.concatenate(mhis)


def _reverse_2bit_fields_u32(x: jnp.ndarray) -> jnp.ndarray:
    """Reverse the 16 two-bit fields of each uint32."""
    m2 = jnp.uint32(0x33333333)
    m4 = jnp.uint32(0x0F0F0F0F)
    m8 = jnp.uint32(0x00FF00FF)
    x = ((x >> 2) & m2) | ((x & m2) << 2)
    x = ((x >> 4) & m4) | ((x & m4) << 4)
    x = ((x >> 8) & m8) | ((x & m8) << 8)
    return (x >> 16) | (x << 16)


def revcomp_lo_hi(
    lo: jnp.ndarray, hi: jnp.ndarray, k: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Reverse-complement hash from the forward (lo, hi) words directly:
    complement every 2-bit base, reverse base order, shift down to bit 0
    (``oracle.revcomp_hash`` in two-word arithmetic — cheaper than a second
    rolling pass)."""
    assert 1 <= k <= 31
    # complement all fields, then reverse the 32 fields of the 64-bit pair
    rev_hi = _reverse_2bit_fields_u32(~lo)  # forward lo becomes the high word
    rev_lo = _reverse_2bit_fields_u32(~hi)
    # shift the 64-bit value right by (64 - 2k)
    s = 64 - 2 * k
    if s == 0:
        out_lo, out_hi = rev_lo, rev_hi
    elif s < 32:
        out_lo = (rev_lo >> s) | (rev_hi << (32 - s))
        out_hi = rev_hi >> s
    else:
        out_lo = rev_hi >> (s - 32) if s > 32 else rev_hi
        out_hi = jnp.zeros_like(rev_hi)
    mask_lo = jnp.uint32(0xFFFFFFFF if k >= 16 else (1 << (2 * k)) - 1)
    mask_hi = jnp.uint32((1 << max(0, 2 * k - 32)) - 1)
    return out_lo & mask_lo, out_hi & mask_hi


def rolling_revcomp_hash(codes: jnp.ndarray, k: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Reverse-complement hash of each window: base t+k-1-m complemented (3-c)
    into bit position 2m. Matches ``oracle.revcomp_hash`` of the forward hash,
    fused into the same slice loop (GPU-path revcomp, ``gpu_counter.py:23-24``)."""
    assert 1 <= k <= 31
    n = codes.shape[0] - k
    lo = jnp.zeros(n, dtype=jnp.uint32)
    hi = jnp.zeros(n, dtype=jnp.uint32)
    for m in range(k):
        c = jnp.uint32(3) - codes[k - 1 - m : k - 1 - m + n]
        if 2 * m < 32:
            lo = lo | (c << 2 * m)
        else:
            hi = hi | (c << (2 * m - 32))
    return lo, hi


def window_mask(
    read_starts: jnp.ndarray, n_bases: jnp.ndarray, k: int, buf: int
) -> jnp.ndarray:
    """bool[buf]: window t covers [t, t+k) of one read entirely.

    ``read_starts``: int32[max_reads], start offsets into the chunk. Padding
    entries may be any value >= ``n_bases``: entries >= buf + k are dropped
    from the scatter, and entries in [n_bases, buf + k) — e.g. the cumsum of
    zero-padded read lengths used by ``chunk_step`` — can only invalidate a
    window t with t < n_bases < t + k, which ``t + k <= n_bases`` already
    rejects (pinned by ``tests/test_device_ops.py``).
    ``n_bases``: scalar int32, number of valid bases in the chunk."""
    starts_flag = (
        jnp.zeros(buf + k, dtype=jnp.int32).at[read_starts].set(1, mode="drop")
    )
    cum = jnp.cumsum(starts_flag)
    # no read start strictly inside (t, t+k): cum[t+k-1] == cum[t]
    same_read = cum[k - 1 : k - 1 + buf] == cum[:buf]
    t = jnp.arange(buf, dtype=jnp.int32)
    return same_read & (t + k <= n_bases)

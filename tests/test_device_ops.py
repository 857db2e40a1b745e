"""Device ops vs numpy oracle: bit-exact pack/unpack/hash/probe/count on JAX."""
import jax.numpy as jnp
import numpy as np
import pytest

from kmer_mapper_tpu import oracle
from kmer_mapper_tpu.index import kmer_index as ki
from kmer_mapper_tpu.index import layout
from kmer_mapper_tpu.models.mapper import KmerMapper, MapperConfig
from kmer_mapper_tpu.ops import encode, hashing, probe
from kmer_mapper_tpu.ops.u32hash import join_u64, mix64, split_u64


def test_device_encode_matches_oracle():
    ascii_bytes = np.frombuffer(b"ACGTacgtNnACGT", dtype=np.uint8)
    codes, invalid = encode.encode_bases(jnp.asarray(ascii_bytes))
    np.testing.assert_array_equal(np.asarray(codes), oracle.encode_bytes(ascii_bytes))
    assert int(invalid.sum()) == 0
    bad = np.frombuffer(b"AXG", dtype=np.uint8)
    codes, invalid = encode.encode_bases(jnp.asarray(bad))
    np.testing.assert_array_equal(np.asarray(invalid), [0, 1, 0])


def test_host_pack_device_unpack_roundtrip():
    rng = np.random.default_rng(0)
    bases = rng.choice(np.frombuffer(b"ACGTacgtNn", dtype=np.uint8), 1000)
    out_words = (len(bases) + 15) // 16 + 2
    packed, n_invalid = encode.host_encode_pack(bases, out_words)
    assert n_invalid == 0
    codes = np.asarray(encode.unpack_codes(jnp.asarray(packed)))
    expect = oracle.encode_bytes(bases)
    np.testing.assert_array_equal(codes[: len(bases)], expect)
    np.testing.assert_array_equal(codes[len(bases) :], 0)
    # invalid counting
    packed, n_invalid = encode.host_encode_pack(np.frombuffer(b"AXGZ", np.uint8), 1)
    assert n_invalid == 2


def test_mix64_numpy_jax_identical():
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 1 << 62, 1000, dtype=np.uint64)
    lo, hi = split_u64(vals)
    a = mix64(lo, hi, seed=7, xp=np)
    b = np.asarray(mix64(jnp.asarray(lo), jnp.asarray(hi), seed=7, xp=jnp))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [1, 4, 16, 17, 31])
def test_rolling_hash_matches_oracle(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 300).astype(np.uint8)
    padded = np.concatenate([codes, np.zeros(k, dtype=np.uint8)]).astype(np.uint32)
    lo, hi = hashing.rolling_kmer_hash(jnp.asarray(padded), k)
    got = join_u64(np.asarray(lo), np.asarray(hi))
    expect = oracle.kmer_hashes(codes, k)
    np.testing.assert_array_equal(got[: len(expect)], expect)


@pytest.mark.parametrize("k", [2, 16, 31])
def test_rolling_revcomp_hash_matches_oracle(k):
    rng = np.random.default_rng(k + 50)
    codes = rng.integers(0, 4, 200).astype(np.uint8)
    padded = np.concatenate([codes, np.zeros(k, dtype=np.uint8)]).astype(np.uint32)
    lo, hi = hashing.rolling_revcomp_hash(jnp.asarray(padded), k)
    got = join_u64(np.asarray(lo), np.asarray(hi))
    expect = oracle.revcomp_hash(oracle.kmer_hashes(codes, k), k)
    np.testing.assert_array_equal(got[: len(expect)], expect)


def test_window_mask_ragged():
    k, buf = 4, 32
    lengths = [6, 3, 10, 4]  # read of 3 < k yields no windows
    starts = np.cumsum([0] + lengths[:-1]).astype(np.int32)
    n_bases = sum(lengths)
    starts_padded = np.full(8, n_bases, dtype=np.int32)
    starts_padded[: len(starts)] = starts
    mask = np.asarray(
        hashing.window_mask(jnp.asarray(starts_padded), jnp.int32(n_bases), k, buf)
    )
    expect = np.zeros(buf, dtype=bool)
    for s, ln in zip(starts, lengths):
        expect[s : s + max(0, ln - k + 1)] = True
    np.testing.assert_array_equal(mask, expect)


def test_probe_matches_host_query():
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(0, 1 << 62, 4000, dtype=np.uint64))
    table = layout.build_table(keys)
    queries = np.concatenate([keys[:500], rng.integers(0, 1 << 62, 500, dtype=np.uint64)])
    qlo, qhi = split_u64(queries)
    got = np.asarray(
        probe.probe_slots(
            jnp.asarray(table.key_lo),
            jnp.asarray(table.key_hi),
            jnp.asarray(qlo),
            jnp.asarray(qhi),
            table.max_probe,
            table.seed,
        )
    )
    expect = layout.query_table(table, queries)
    np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("method", ["scatter", "sorted"])
def test_accumulators_match_bincount(method):
    rng = np.random.default_rng(4)
    n_buckets = 16
    n_slots = n_buckets * layout.BUCKET_KEYS
    n = 1000
    bucket = rng.integers(0, n_buckets, n).astype(np.int32)
    lane_hit = rng.integers(-1, layout.BUCKET_KEYS, n)  # -1 = miss
    mask = np.zeros((n, layout.BUCKET_KEYS), dtype=np.uint32)
    mask[lane_hit >= 0, lane_hit[lane_hit >= 0]] = 1
    valid = rng.random(n) < 0.8
    counts0 = rng.integers(0, 5, n_slots).astype(np.uint32)
    got = np.asarray(
        probe.ACCUMULATORS[method](
            jnp.asarray(counts0), jnp.asarray(bucket), jnp.asarray(mask), jnp.asarray(valid)
        )
    )
    keep = valid & (lane_hit >= 0)
    slots = bucket[keep] * layout.BUCKET_KEYS + lane_hit[keep]
    expect = counts0 + np.bincount(slots, minlength=n_slots).astype(np.uint32)
    np.testing.assert_array_equal(got, expect)


def _pack_reads(reads: list[str], config: MapperConfig):
    flat = "".join(reads)
    bases = np.frombuffer(flat.encode(), dtype=np.uint8)
    packed, n_invalid = encode.host_encode_pack(bases, config.packed_words)
    lengths = np.zeros(config.max_reads, dtype=np.uint16)
    lengths[: len(reads)] = [len(r) for r in reads]
    return packed, lengths, len(flat), n_invalid


@pytest.mark.parametrize("accumulate", ["scatter", "sorted"])
def test_full_chunk_step_matches_oracle(accumulate):
    rng = np.random.default_rng(5)
    k = 7
    reads = ["".join(rng.choice(list("ACGT"), rng.integers(4, 40))) for _ in range(60)]
    read_codes = [oracle.encode_string(r) for r in reads]
    read_kmers = np.concatenate(
        [oracle.kmer_hashes(c, k) for c in read_codes if len(c) >= k]
    )
    entry_kmers = np.concatenate(
        [rng.choice(read_kmers, 80), rng.integers(0, 4**k, 40, dtype=np.uint64)]
    )
    nodes = rng.integers(0, 50, len(entry_kmers)).astype(np.int32)
    arrays = oracle.build_kmer_index(entry_kmers, nodes, 251)
    dev_index = ki.TpuKmerIndex.from_arrays(arrays)

    config = MapperConfig(k=k, buf=2048, max_reads=128, accumulate=accumulate)
    mapper = KmerMapper(dev_index, config)
    mapper.map_chunk(*_pack_reads(reads, config))
    got = mapper.node_counts()

    oracle_kmers = oracle.kmer_hashes_ragged(
        np.concatenate(read_codes), np.array([len(r) for r in reads]), k
    )
    expect = oracle.map_kmers_to_index(arrays, oracle_kmers)
    np.testing.assert_array_equal(got, expect)
    assert mapper.n_kmers_mapped == len(oracle_kmers)


def test_chunk_step_revcomp():
    rng = np.random.default_rng(6)
    k = 5
    reads = ["".join(rng.choice(list("ACGT"), 20)) for _ in range(20)]
    read_codes = [oracle.encode_string(r) for r in reads]
    fwd = np.concatenate([oracle.kmer_hashes(c, k) for c in read_codes])
    entry_kmers = rng.choice(np.concatenate([fwd, oracle.revcomp_hash(fwd, k)]), 60)
    nodes = np.arange(len(entry_kmers), dtype=np.int32)
    arrays = oracle.build_kmer_index(entry_kmers, nodes, 499)
    dev_index = ki.TpuKmerIndex.from_arrays(arrays)

    config = MapperConfig(k=k, buf=1024, max_reads=64, revcomp=True)
    mapper = KmerMapper(dev_index, config)
    mapper.map_chunk(*_pack_reads(reads, config))
    got = mapper.node_counts()

    queries = np.concatenate([fwd, oracle.revcomp_hash(fwd, k)])
    expect = oracle.map_kmers_to_index(arrays, queries)
    np.testing.assert_array_equal(got, expect)


def test_map_hashes_counter_parity():
    rng = np.random.default_rng(7)
    keys = np.unique(rng.integers(0, 1 << 62, 500, dtype=np.uint64))
    dev_index = ki.TpuKmerIndex.from_counter_keys(keys)
    mapper = KmerMapper(dev_index, MapperConfig(k=31, buf=256, max_reads=16))
    queries = np.concatenate(
        [rng.choice(keys, 2000), rng.integers(0, 1 << 62, 300, dtype=np.uint64)]
    )
    mapper.map_hashes(queries)
    got_kmers, got_counts = mapper.kmer_counts()
    expect = oracle.count_unique_kmers(got_kmers, queries)
    np.testing.assert_array_equal(got_counts, expect)


def test_invalid_base_tracking_host():
    config = MapperConfig(k=3, buf=64, max_reads=8)
    dev_index = ki.TpuKmerIndex.from_counter_keys(np.array([1, 2, 3], dtype=np.uint64))
    mapper = KmerMapper(dev_index, config)
    mapper.map_chunk(*_pack_reads(["ACGXGA"], config))
    assert mapper.n_invalid_bases == 1


def test_super_batch_matches_single_dispatch():
    """super_batch folds chunks into one scanned dispatch; results identical."""
    rng = np.random.default_rng(11)
    k = 7
    keys = np.unique(rng.integers(0, 4**k, 500, dtype=np.uint64))
    dev_index = ki.TpuKmerIndex.from_counter_keys(keys)
    chunk_sets = []
    base = MapperConfig(k=k, buf=512, max_reads=32)
    for _ in range(7):  # 7 chunks: exercises a padded final super-batch
        reads = ["".join(rng.choice(list("ACGT"), 40)) for _ in range(10)]
        chunk_sets.append(_pack_reads(reads, base))

    results = {}
    for name, kw in {
        "sb1": dict(super_batch=1),
        "sb3": dict(super_batch=3),
        "sb3-sorted": dict(super_batch=3, accumulate="sorted"),
    }.items():
        config = MapperConfig(k=k, buf=512, max_reads=32, **kw)
        mapper = KmerMapper(dev_index, config)
        for c in chunk_sets:
            mapper.map_chunk(*c)
        results[name] = (mapper.node_counts(), mapper.n_kmers_mapped)
    for name in ("sb3", "sb3-sorted"):
        np.testing.assert_array_equal(results["sb1"][0], results[name][0])
        assert results["sb1"][1] == results[name][1]


@pytest.mark.parametrize("k", [1, 4, 15, 16, 17, 31])
def test_packed_rolling_hash_matches_oracle(k):
    rng = np.random.default_rng(k + 200)
    n = 512
    codes = rng.integers(0, 4, n).astype(np.uint8)
    packed, _ = encode.host_encode_pack(
        np.frombuffer("".join(oracle.ALPHABET[c] for c in codes).encode(), np.uint8),
        n // 16 + 2,
    )
    lo, hi = hashing.rolling_kmer_hash_packed(jnp.asarray(packed), k)
    got = join_u64(np.asarray(lo), np.asarray(hi))
    expect = oracle.kmer_hashes(codes, k)
    np.testing.assert_array_equal(got[: len(expect)], expect)
    # identical to the unpack-based formulation on the padded tail too
    codes_padded = np.concatenate([codes, np.zeros(32, np.uint8)]).astype(np.uint32)
    lo2, hi2 = hashing.rolling_kmer_hash(jnp.asarray(codes_padded[: n + k]), k)
    np.testing.assert_array_equal(np.asarray(lo)[:n], np.asarray(lo2)[:n])
    np.testing.assert_array_equal(np.asarray(hi)[:n], np.asarray(hi2)[:n])


@pytest.mark.parametrize("k", [1, 4, 16, 17, 31])
def test_revcomp_lo_hi_matches_oracle(k):
    rng = np.random.default_rng(k + 300)
    kmers = rng.integers(0, 1 << (2 * k), 500, dtype=np.uint64)
    lo, hi = split_u64(kmers)
    rlo, rhi = hashing.revcomp_lo_hi(jnp.asarray(lo), jnp.asarray(hi), k)
    got = join_u64(np.asarray(rlo), np.asarray(rhi))
    np.testing.assert_array_equal(got, oracle.revcomp_hash(kmers, k))


def test_window_mask_padding_contract():
    """Pin the documented padding contract: padding read_starts entries equal
    to n_bases (what chunk_step's cumsum produces) must not invalidate any
    window that t + k <= n_bases keeps (``hashing.window_mask`` docstring)."""
    k, buf = 5, 64
    n_bases = 40  # one read covering [0, 40)
    starts_nb = np.full(16, n_bases, dtype=np.int32)
    starts_nb[0] = 0
    starts_big = np.full(16, buf + k, dtype=np.int32)  # the 'safe' padding
    starts_big[0] = 0
    m1 = np.asarray(hashing.window_mask(jnp.asarray(starts_nb), jnp.int32(n_bases), k, buf))
    m2 = np.asarray(hashing.window_mask(jnp.asarray(starts_big), jnp.int32(n_bases), k, buf))
    np.testing.assert_array_equal(m1, m2)
    assert m1[: n_bases - k + 1].all() and not m1[n_bases - k + 1 :].any()


def test_feistel_mix_bijective_and_backend_identical():
    from kmer_mapper_tpu.ops.u32hash import feistel_mix, feistel_unmix

    rng = np.random.default_rng(3)
    lo = rng.integers(0, 1 << 32, 4096, dtype=np.int64).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, 4096, dtype=np.int64).astype(np.uint32)
    for seed in (0, 13, 26):
        m_lo, m_hi = feistel_mix(lo, hi, seed=seed)
        jl, jh = feistel_mix(jnp.asarray(lo), jnp.asarray(hi), seed=seed, xp=jnp)
        np.testing.assert_array_equal(m_lo, np.asarray(jl))
        np.testing.assert_array_equal(m_hi, np.asarray(jh))
        rl, rh = feistel_unmix(m_lo, m_hi, seed=seed)
        np.testing.assert_array_equal(rl, lo)
        np.testing.assert_array_equal(rh, hi)
    # distinct inputs stay distinct through the permutation (spot injectivity)
    m_lo, m_hi = feistel_mix(lo, hi, seed=1)
    packed = join_u64(m_lo, m_hi)
    assert len(np.unique(packed)) == len(np.unique(join_u64(lo, hi)))


def test_bucket_of_uniformity_and_low_word_grouping():
    """bucket_of must equal the high bits of the mixed low word (the probe's
    bucket contract) and spread clustered kmers."""
    from kmer_mapper_tpu.ops.u32hash import bucket_of, bucket_shift, feistel_mix

    rng = np.random.default_rng(4)
    # adversarial near-identical kmers: same high word, low word 0..N
    kmers = np.arange(1 << 14, dtype=np.uint64) | (np.uint64(0x2AB) << np.uint64(40))
    lo, hi = split_u64(kmers)
    n_buckets = 1 << 10
    b = bucket_of(lo, hi, n_buckets, seed=0)
    m_lo, _ = feistel_mix(lo, hi, seed=0)
    np.testing.assert_array_equal(b, m_lo >> np.uint32(bucket_shift(n_buckets)))
    counts = np.bincount(b.astype(np.int64), minlength=n_buckets)
    assert counts.max() < 16 * (len(kmers) / n_buckets)  # no pathological pile-up

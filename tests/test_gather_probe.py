"""Gather probe (ops/probe.py) and the chunk steps that count through it,
bit-exact against the oracle on the CPU: hits, misses, invalid-window
masking, heavy duplicates (poly-A style skew), chain wrapping, accumulation
across calls, dense tables, the full chunk step with and without reverse
complements, and the k sweep across the 16-base word boundary. Every case
runs under both count accumulators."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kmer_mapper_tpu import oracle
from kmer_mapper_tpu.index import kmer_index as ki
from kmer_mapper_tpu.index import layout
from kmer_mapper_tpu.io import readers
from kmer_mapper_tpu.models.mapper import KmerMapper, MapperConfig
from kmer_mapper_tpu.ops import encode, probe
from kmer_mapper_tpu.ops.u32hash import feistel_mix, split_u64

ACCUMULATE = pytest.mark.parametrize("accumulate", ["scatter", "sorted"])


def _run_gather(table, queries, valid, accumulate, counts0=None):
    qlo, qhi = split_u64(queries)
    counts = jnp.asarray(
        counts0 if counts0 is not None else np.zeros(table.n_slots, np.uint32)
    )
    bucket, mask = probe.probe_hits(
        jnp.asarray(table.key_lo), jnp.asarray(table.key_hi),
        jnp.asarray(qlo), jnp.asarray(qhi), table.max_probe, table.seed,
    )
    out = probe.ACCUMULATORS[accumulate](counts, bucket, mask, jnp.asarray(valid))
    return np.asarray(out)


def _expect(table, queries, valid, counts0=None):
    slots = layout.query_table(table, np.asarray(queries)[valid])
    base = counts0 if counts0 is not None else np.zeros(table.n_slots, np.uint32)
    return base + np.bincount(slots[slots >= 0], minlength=table.n_slots).astype(
        np.uint32
    )


def _chained_table(rng, n_keys, load):
    keys = np.unique(rng.integers(0, 1 << 62, n_keys, dtype=np.uint64))
    n_buckets = layout._next_pow2(int(np.ceil(len(keys) / layout.BUCKET_KEYS / load)))
    return keys, layout.build_table(keys, n_buckets=n_buckets)


@ACCUMULATE
def test_gather_probe_hits_misses_and_masking(accumulate):
    rng = np.random.default_rng(0)
    keys = np.unique(rng.integers(0, 1 << 62, 20000, dtype=np.uint64))
    table = layout.build_table(keys)
    queries = np.concatenate(
        [rng.choice(keys, 4000), rng.integers(0, 1 << 62, 3000, dtype=np.uint64)]
    )
    rng.shuffle(queries)
    valid = rng.random(len(queries)) < 0.85
    np.testing.assert_array_equal(
        _run_gather(table, queries, valid, accumulate), _expect(table, queries, valid)
    )


@ACCUMULATE
def test_gather_probe_heavy_duplicates_skew(accumulate):
    """One kmer repeated thousands of times (the poly-A case after N->A)
    must count exactly: same-address contention in the accumulator."""
    rng = np.random.default_rng(1)
    keys = np.unique(rng.integers(0, 1 << 62, 2000, dtype=np.uint64))
    table = layout.build_table(keys)
    queries = np.concatenate([np.full(5000, keys[3], np.uint64), rng.choice(keys, 500)])
    valid = np.ones(len(queries), bool)
    got = _run_gather(table, queries, valid, accumulate)
    np.testing.assert_array_equal(got, _expect(table, queries, valid))
    assert got[layout.query_table(table, keys[3:4])[0]] >= 5000


@ACCUMULATE
def test_gather_probe_accumulates_into_existing_counts(accumulate):
    rng = np.random.default_rng(2)
    keys = np.unique(rng.integers(0, 1 << 62, 5000, dtype=np.uint64))
    table = layout.build_table(keys)
    counts0 = rng.integers(0, 7, table.n_slots).astype(np.uint32)
    queries = rng.choice(keys, 2000)
    valid = np.ones(len(queries), bool)
    np.testing.assert_array_equal(
        _run_gather(table, queries, valid, accumulate, counts0=counts0.copy()),
        _expect(table, queries, valid, counts0=counts0),
    )


@ACCUMULATE
def test_gather_probe_chained_table(accumulate):
    """High-load table with wrapped collision chains: keys stored at probe
    offsets > 0 are found in later rounds."""
    rng = np.random.default_rng(3)
    keys, table = _chained_table(rng, 4000, 0.8)
    assert table.max_probe > 1
    queries = np.concatenate([keys, rng.integers(0, 1 << 62, 1000, dtype=np.uint64)])
    valid = np.ones(len(queries), bool)
    np.testing.assert_array_equal(
        _run_gather(table, queries, valid, accumulate), _expect(table, queries, valid)
    )


@ACCUMULATE
def test_gather_probe_dense_table_deep_chains(accumulate):
    """Dense table (chains beyond the default 8-round limit, built with a
    raised max_probe_limit): every round is probed, counts stay exact."""
    rng = np.random.default_rng(31)
    keys = np.unique(rng.integers(0, 1 << 62, 6600, dtype=np.uint64))
    n_buckets = 1024  # ~6.4 keys per 8-slot bucket
    table = layout.build_table(keys, n_buckets=n_buckets, max_probe_limit=16)
    assert table.n_buckets == n_buckets, "build must not have grown"
    assert table.max_probe > layout.MAX_PROBE_LIMIT
    queries = np.concatenate([keys, rng.integers(0, 1 << 62, 1000, dtype=np.uint64)])
    valid = rng.random(len(queries)) < 0.95
    np.testing.assert_array_equal(
        _run_gather(table, queries, valid, accumulate), _expect(table, queries, valid)
    )


@ACCUMULATE
def test_gather_probe_tiny_table(accumulate):
    keys = np.array([5, 9, 1 << 40], dtype=np.uint64)
    table = layout.build_table(keys)
    queries = np.array([5, 5, 9, 123, 1 << 40], dtype=np.uint64)
    valid = np.ones(5, bool)
    np.testing.assert_array_equal(
        _run_gather(table, queries, valid, accumulate), _expect(table, queries, valid)
    )


def test_probe_mixed_sentinel_query_never_hits():
    """The all-ones mixed pattern marks padding rows of the plane step: it
    must miss even though every empty slot stores that pattern."""
    keys = np.array([5, 9], dtype=np.uint64)
    table = layout.build_table(keys)
    ones = jnp.full(3, 0xFFFFFFFF, jnp.uint32)
    _, mask = probe.probe_mixed(
        jnp.asarray(table.key_lo), jnp.asarray(table.key_hi), ones, ones,
        table.max_probe,
    )
    assert not np.asarray(mask).any()


@pytest.mark.parametrize("n_shards", [2, 4, 16])
def test_probe_mixed_shards_partition_the_table(n_shards):
    """Row-offset probing over bucket-range shards (the sharded step's core,
    including shards smaller than one chain block): every key is found by
    exactly the shard that stores it, and the shard results concatenate to
    the single-table result."""
    rng = np.random.default_rng(40 + n_shards)
    keys, table = _chained_table(rng, 3000, 0.8)
    queries = np.concatenate([keys, rng.integers(0, 1 << 62, 500, dtype=np.uint64)])
    m_lo, m_hi = feistel_mix(*map(jnp.asarray, split_u64(queries)), seed=table.seed, xp=jnp)
    nb_local = table.n_buckets // n_shards
    parts = []
    for x in range(n_shards):
        rows = slice(x * nb_local, (x + 1) * nb_local)
        bucket, mask = probe.probe_mixed(
            jnp.asarray(table.key_lo[rows]), jnp.asarray(table.key_hi[rows]),
            m_lo, m_hi, table.max_probe,
            n_buckets_global=table.n_buckets, row_offset=x * nb_local,
        )
        local = probe.accumulate_scatter(
            jnp.zeros(nb_local * layout.BUCKET_KEYS, jnp.uint32), bucket, mask,
            jnp.ones(len(queries), bool),
        )
        parts.append(np.asarray(local))
    valid = np.ones(len(queries), bool)
    np.testing.assert_array_equal(np.concatenate(parts), _expect(table, queries, valid))


def _pack_reads(reads, config):
    flat = "".join(reads)
    bases = np.frombuffer(flat.encode(), dtype=np.uint8)
    packed, n_invalid = encode.host_encode_pack(bases, config.packed_words)
    lengths = np.zeros(config.max_reads, dtype=np.uint16)
    lengths[: len(reads)] = [len(r) for r in reads]
    return packed, lengths, len(flat), n_invalid


def _index_for(rng, fwd, k, n_random=60, with_revcomp=False):
    pool = np.concatenate([fwd, oracle.revcomp_hash(fwd, k)]) if with_revcomp else fwd
    mask = np.uint64(4**k - 1)
    entry_kmers = np.concatenate(
        [rng.choice(pool, 150), rng.integers(0, 1 << 62, n_random, dtype=np.uint64) & mask]
    )
    nodes = rng.integers(0, 70, len(entry_kmers)).astype(np.int32)
    arrays = oracle.build_kmer_index(entry_kmers, nodes, 997)
    return arrays, ki.TpuKmerIndex.from_arrays(arrays)


@ACCUMULATE
@pytest.mark.parametrize("revcomp", [False, True])
def test_chunk_step_matches_oracle(revcomp, accumulate):
    rng = np.random.default_rng(7)
    k = 9
    reads = ["".join(rng.choice(list("ACGT"), rng.integers(6, 50))) for _ in range(80)]
    fwd = oracle.kmer_hashes_ragged(
        oracle.encode_string("".join(reads)), np.array([len(r) for r in reads]), k
    )
    arrays, index = _index_for(rng, fwd, k, with_revcomp=True)
    config = MapperConfig(
        k=k, buf=8192, max_reads=256, revcomp=revcomp, accumulate=accumulate
    )
    mapper = KmerMapper(index, config)
    mapper.map_chunk(*_pack_reads(reads, config))
    queries = np.concatenate([fwd, oracle.revcomp_hash(fwd, k)]) if revcomp else fwd
    np.testing.assert_array_equal(
        mapper.node_counts(), oracle.map_kmers_to_index(arrays, queries)
    )
    assert mapper.n_kmers_mapped == len(fwd)


@ACCUMULATE
@pytest.mark.parametrize("k", [1, 5, 15, 16, 17, 31])
def test_chunk_step_k_boundaries(k, accumulate):
    """k sweep across the 16-base word boundary (k<=16: hi word is 0; the
    mixed words still spread over both) — full chunk step vs oracle."""
    rng = np.random.default_rng(100 + k)
    reads = ["".join(rng.choice(list("ACGT"), rng.integers(k, k + 40))) for _ in range(50)]
    fwd = oracle.kmer_hashes_ragged(
        oracle.encode_string("".join(reads)), np.array([len(r) for r in reads]), k
    )
    arrays, index = _index_for(rng, fwd, k, n_random=30)
    config = MapperConfig(k=k, buf=4096, max_reads=128, accumulate=accumulate)
    mapper = KmerMapper(index, config)
    mapper.map_chunk(*_pack_reads(reads, config))
    np.testing.assert_array_equal(
        mapper.node_counts(), oracle.map_kmers_to_index(arrays, fwd)
    )


@ACCUMULATE
@pytest.mark.parametrize("revcomp", [False, True])
def test_chunk_step_fixed_read_len_matches_ragged(accumulate, revcomp):
    """config.read_len slices the static valid-window pattern instead of
    masking; counts must be identical to the ragged step and the oracle."""
    rng = np.random.default_rng(11)
    k, L, n_reads = 9, 37, 70
    reads = ["".join(rng.choice(list("ACGT"), L)) for _ in range(n_reads)]
    fwd = oracle.kmer_hashes_ragged(
        oracle.encode_string("".join(reads)), np.full(n_reads, L), k
    )
    arrays, index = _index_for(rng, fwd, k, n_random=50, with_revcomp=True)
    kw = dict(k=k, buf=4096, max_reads=256, revcomp=revcomp, accumulate=accumulate)
    fixed = KmerMapper(index, MapperConfig(read_len=L, **kw))
    fixed.map_chunk(*_pack_reads(reads, fixed.config))
    ragged = KmerMapper(index, MapperConfig(**kw))
    ragged.map_chunk(*_pack_reads(reads, ragged.config))
    queries = np.concatenate([fwd, oracle.revcomp_hash(fwd, k)]) if revcomp else fwd
    expect = oracle.map_kmers_to_index(arrays, queries)
    np.testing.assert_array_equal(fixed.node_counts(), expect)
    np.testing.assert_array_equal(ragged.node_counts(), expect)
    assert fixed.n_kmers_mapped == ragged.n_kmers_mapped == len(fwd)


def test_fixed_read_len_falls_back_on_ragged_chunk():
    """A chunk whose reads are not uniformly read_len long must take the
    ragged twin step and still count exactly."""
    rng = np.random.default_rng(12)
    k, L = 9, 31
    uniform = ["".join(rng.choice(list("ACGT"), L)) for _ in range(20)]
    ragged = ["".join(rng.choice(list("ACGT"), rng.integers(12, 60))) for _ in range(20)]
    all_reads = uniform + ragged
    fwd = oracle.kmer_hashes_ragged(
        oracle.encode_string("".join(all_reads)), np.array([len(r) for r in all_reads]), k
    )
    arrays, index = _index_for(rng, fwd, k, n_random=40)
    config = MapperConfig(k=k, buf=4096, max_reads=128, read_len=L)
    mapper = KmerMapper(index, config)
    mapper.map_chunk(*_pack_reads(uniform, config))  # fixed fast path
    mapper.map_chunk(*_pack_reads(ragged, config))  # fallback twin
    assert mapper._ragged_step is not None
    np.testing.assert_array_equal(
        mapper.node_counts(), oracle.map_kmers_to_index(arrays, fwd)
    )
    assert mapper.n_kmers_mapped == len(fwd)


@ACCUMULATE
def test_plane_step_partial_chunk_matches_slice_step(accumulate):
    """A strided chunk holding fewer reads than its row capacity: the rows
    past ``n_reads`` carry the sentinel pattern and must count nothing; the
    plane step equals the slice step on the same reads."""
    rng = np.random.default_rng(13)
    k, L = 21, 45
    reads = ["".join(rng.choice(list("ACGTN"), L)) for _ in range(17)]
    fwd = oracle.kmer_hashes_ragged(
        oracle.encode_string("".join(reads).replace("N", "A")), np.full(len(reads), L), k
    )
    arrays, index = _index_for(rng, fwd, k)
    config = MapperConfig(k=k, buf=4096, max_reads=128, read_len=L, accumulate=accumulate)
    chunk = readers.SequenceChunk(
        bases=np.frombuffer("".join(reads).encode(), np.uint8).copy(),
        read_starts=np.arange(len(reads), dtype=np.int64) * L,
    )
    (packed, lengths, nb, nr, ninv, strided), = readers.pack_for_device(
        iter([chunk]), config.buf, config.max_reads, k, read_len=L
    )
    assert strided and nr < readers.strided_rows(config.buf, L)
    plane = KmerMapper(index, config)
    plane.map_chunk(packed, lengths, nb, ninv, strided=True)
    sliced = KmerMapper(index, config)
    sliced.map_chunk(*_pack_reads(reads, config))
    np.testing.assert_array_equal(plane.slot_counts(), sliced.slot_counts())
    np.testing.assert_array_equal(
        plane.node_counts(), oracle.map_kmers_to_index(arrays, fwd)
    )
    assert plane.n_kmers_mapped == len(fwd)


@ACCUMULATE
def test_map_hashes_pads_to_power_of_two(accumulate, monkeypatch):
    """map_hashes pads each batch to a power of two: batches of 600 and 1000
    share one compiled step, padding never counts, and an empty batch is a
    no-op."""
    rng = np.random.default_rng(14)
    keys = np.unique(rng.integers(0, 1 << 62, 3000, dtype=np.uint64))
    index = ki.TpuKmerIndex.from_counter_keys(keys)
    mapper = KmerMapper(index, MapperConfig(k=31, buf=256, max_reads=16, accumulate=accumulate))
    a = np.concatenate([rng.choice(keys, 500), rng.integers(0, 1 << 62, 100, dtype=np.uint64)])
    b = rng.choice(keys, 1000)
    mapper.map_hashes(a)
    mapper.map_hashes(b)
    mapper.map_hashes(np.zeros(0, np.uint64))
    assert list(mapper._hash_steps) == [1024]
    both = np.concatenate([a, b])
    expect = _expect(index.table, both, np.ones(len(both), bool))
    np.testing.assert_array_equal(mapper.slot_counts(), expect)
    assert mapper.n_kmers_mapped == len(both)


@pytest.mark.parametrize("backend", ["cpu", "gpu", "rocm"])
def test_default_config_ignores_the_backend(backend, monkeypatch):
    """default_config is the same whatever backend JAX reports."""
    from kmer_mapper_tpu.models.mapper import default_config

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    kw = dict(k=21, buf=1 << 14, max_reads=512, read_len=151)
    assert default_config(**kw) == MapperConfig(**kw)
    assert default_config() == MapperConfig()

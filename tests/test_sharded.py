"""Multi-device tests on the 8-virtual-CPU-device mesh: sharded table probe,
data-parallel accumulation, collective finalization — bit-exact vs oracle."""
import numpy as np
import pytest

import jax

from kmer_mapper_tpu import oracle
from kmer_mapper_tpu.index import kmer_index as ki
from kmer_mapper_tpu.index import layout
from kmer_mapper_tpu.io import readers
from kmer_mapper_tpu.models.mapper import MapperConfig
from kmer_mapper_tpu.parallel import ShardedKmerMapper, batch_packed_chunks, make_mesh


def _setup(rng, k, n_reads=200):
    reads = ["".join(rng.choice(list("ACGT"), rng.integers(20, 80))) for _ in range(n_reads)]
    codes = [oracle.encode_string(r) for r in reads]
    read_kmers = oracle.kmer_hashes_ragged(
        np.concatenate(codes), np.array([len(c) for c in codes]), k
    )
    mask = np.uint64(4**k - 1) if k < 32 else np.uint64(-1)
    entry_kmers = np.concatenate(
        [rng.choice(read_kmers, 300), rng.integers(0, 1 << 62, 100, dtype=np.uint64) & mask]
    )
    nodes = rng.integers(0, 150, len(entry_kmers)).astype(np.int32)
    arrays = oracle.build_kmer_index(entry_kmers, nodes, 1999)
    expect = oracle.map_kmers_to_index(arrays, read_kmers)
    return reads, arrays, expect


def _chunks_from_reads(reads, config):
    flat = "".join(reads)
    chunk = readers.SequenceChunk(
        bases=np.frombuffer(flat.encode(), dtype=np.uint8),
        read_starts=np.cumsum([0] + [len(r) for r in reads[:-1]]).astype(np.int64),
    )
    return readers.pack_for_device(iter([chunk]), config.buf, config.max_reads, config.k)


def _run(mapper, reads, config):
    packed = _chunks_from_reads(reads, config)
    for batch in batch_packed_chunks(
        packed, mapper.n_data, config.packed_words, config.max_reads
    ):
        mapper.map_batch(*batch)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_mapping_matches_oracle(shape):
    d, x = shape
    assert len(jax.devices()) >= d * x
    rng = np.random.default_rng(d * 10 + x)
    k = 9
    reads, arrays, expect = _setup(rng, k)
    mesh = make_mesh(n_devices=d * x, index_parallel=x)
    config = MapperConfig(k=k, buf=1024, max_reads=64)
    mapper = ShardedKmerMapper(ki.TpuKmerIndex.from_arrays(arrays), config, mesh)
    _run(mapper, reads, config)
    got = mapper.node_counts()
    np.testing.assert_array_equal(got, expect)
    assert mapper.n_kmers_mapped == sum(max(0, len(r) - k + 1) for r in reads)


def test_sharded_revcomp_and_frequency():
    rng = np.random.default_rng(42)
    k = 7
    reads = ["".join(rng.choice(list("ACGT"), 40)) for _ in range(50)]
    codes = [oracle.encode_string(r) for r in reads]
    fwd = oracle.kmer_hashes_ragged(
        np.concatenate(codes), np.array([len(c) for c in codes]), k
    )
    entry_kmers = rng.choice(np.concatenate([fwd, oracle.revcomp_hash(fwd, k)]), 150)
    nodes = rng.integers(0, 60, len(entry_kmers)).astype(np.int32)
    freqs = rng.choice([1, 1001], len(entry_kmers), p=[0.9, 0.1]).astype(np.uint16)
    arrays = oracle.build_kmer_index(entry_kmers, nodes, 499, frequencies=freqs)
    queries = np.concatenate([fwd, oracle.revcomp_hash(fwd, k)])
    expect = oracle.map_kmers_to_index(arrays, queries)

    mesh = make_mesh(n_devices=8, index_parallel=2)
    config = MapperConfig(k=k, buf=512, max_reads=32, revcomp=True, accumulate="sorted")
    mapper = ShardedKmerMapper(ki.TpuKmerIndex.from_arrays(arrays), config, mesh)
    _run(mapper, reads, config)
    np.testing.assert_array_equal(mapper.node_counts(), expect)


def test_sharded_probe_chained_high_load():
    """High-load table -> long collision chains; with 8 index shards every key
    must still count exactly once (chains wrap inside CHAIN_BLOCK-aligned
    blocks, so block-aligned shards contain them fully)."""
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(0, 1 << 62, 2048, dtype=np.uint64))
    n_buckets = layout._next_pow2(int(np.ceil(len(keys) / layout.BUCKET_KEYS / 0.85)))
    table = layout.build_table(keys, n_buckets=n_buckets)
    slots = layout.query_table(table, keys)
    dev_index = ki.TpuKmerIndex(
        table=table,
        entry_slot=slots.astype(np.int32),
        entry_node=np.arange(len(keys), dtype=np.int32),
        entry_frequency=np.ones(len(keys), dtype=np.uint16),
        max_node_id=len(keys) - 1,
        n_unique=len(keys),
    )
    k = 31
    mesh = make_mesh(n_devices=8, index_parallel=8)
    config = MapperConfig(k=k, buf=256, max_reads=16)
    mapper = ShardedKmerMapper(dev_index, config, mesh)
    reads = [
        "".join(oracle.ALPHABET[(int(key) >> (2 * i)) & 3] for i in range(k)) for key in keys
    ]
    _run(mapper, reads, config)
    np.testing.assert_array_equal(mapper.node_counts(), 1)


def test_sharded_save_load_state_round_trip(tmp_path):
    """Checkpoint mid-run on one mesh, resume on a fresh mapper: final counts
    must equal the uninterrupted run (multi-chip resume parity with
    KmerMapper.save_state/load_state)."""
    rng = np.random.default_rng(77)
    k = 9
    reads, arrays, expect = _setup(rng, k)
    mesh = make_mesh(n_devices=4, index_parallel=2)
    config = MapperConfig(k=k, buf=1024, max_reads=64)
    index = ki.TpuKmerIndex.from_arrays(arrays)

    half = len(reads) // 2
    mapper = ShardedKmerMapper(index, config, mesh)
    _run(mapper, reads[:half], config)
    ckpt = tmp_path / "state.npz"
    mapper.save_state(ckpt)
    kmers_at_ckpt = mapper.n_kmers_mapped

    resumed = ShardedKmerMapper(index, config, mesh)
    resumed.load_state(ckpt)
    assert resumed.n_kmers_mapped == kmers_at_ckpt
    _run(resumed, reads[half:], config)
    np.testing.assert_array_equal(resumed.node_counts(), expect)

    # shape mismatch (different mesh) is refused, not silently mis-sharded
    other = ShardedKmerMapper(index, config, make_mesh(n_devices=8, index_parallel=2))
    with pytest.raises(ValueError, match="does not match"):
        other.load_state(ckpt)


def _index_with_table(arrays, n_buckets):
    unique = np.unique(arrays.kmers)
    table = layout.build_table(unique, n_buckets=n_buckets)
    slots = layout.query_table(table, arrays.kmers)
    return ki.TpuKmerIndex(
        table=table,
        entry_slot=slots.astype(np.int32),
        entry_node=arrays.nodes,
        entry_frequency=arrays.frequencies,
        max_node_id=arrays.max_node_id(),
        n_unique=len(unique),
    )


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_fixed_read_len_plane_path(shape):
    """Fixed-length reads on the sharded path take the word-plane step (host
    restride + plane hash inside shard_map) on every mesh shape, including
    index shards smaller than one chain block — bit-exact vs the oracle, and
    a batch with an off-length read falls back to the ragged step."""
    d, x = shape
    rng = np.random.default_rng(91 + d)
    k, L = 9, 37
    reads = ["".join(rng.choice(list("ACGT"), L)) for _ in range(120)]
    codes = [oracle.encode_string(r) for r in reads]
    read_kmers = oracle.kmer_hashes_ragged(
        np.concatenate(codes), np.array([len(c) for c in codes]), k
    )
    entry_kmers = np.concatenate(
        [rng.choice(read_kmers, 200),
         rng.integers(0, 1 << (2 * k), 100, dtype=np.uint64)]
    )
    nodes = rng.integers(0, 150, len(entry_kmers)).astype(np.int32)
    arrays = oracle.build_kmer_index(entry_kmers, nodes, 1999)
    expect = oracle.map_kmers_to_index(arrays, read_kmers)
    dev_index = _index_with_table(arrays, 2 * layout.CHAIN_BLOCK)
    mesh = make_mesh(n_devices=d * x, index_parallel=x)
    config = MapperConfig(k=k, buf=1024, max_reads=64, read_len=L)
    mapper = ShardedKmerMapper(dev_index, config, mesh)
    _run(mapper, reads, config)
    assert set(mapper._steps) == {"plane"}  # the plane twin ran, nothing else
    np.testing.assert_array_equal(mapper.node_counts(), expect)
    assert mapper.n_kmers_mapped == len(reads) * (L - k + 1)

    # an off-length read anywhere in the batch -> ragged fallback, same math
    reads_mixed = reads[:40] + ["ACGT" * 12] + reads[40:]
    codes_m = [oracle.encode_string(r) for r in reads_mixed]
    kmers_m = oracle.kmer_hashes_ragged(
        np.concatenate(codes_m), np.array([len(c) for c in codes_m]), k
    )
    mapper_m = ShardedKmerMapper(dev_index, config, mesh)
    _run(mapper_m, reads_mixed, config)
    assert "ragged" in mapper_m._steps
    np.testing.assert_array_equal(
        mapper_m.node_counts(), oracle.map_kmers_to_index(arrays, kmers_m)
    )


def test_sharded_plane_revcomp():
    rng = np.random.default_rng(92)
    k, L = 7, 33
    reads = ["".join(rng.choice(list("ACGT"), L)) for _ in range(60)]
    codes = [oracle.encode_string(r) for r in reads]
    fwd = oracle.kmer_hashes_ragged(
        np.concatenate(codes), np.array([len(c) for c in codes]), k
    )
    entry_kmers = rng.choice(np.concatenate([fwd, oracle.revcomp_hash(fwd, k)]), 150)
    nodes = rng.integers(0, 60, len(entry_kmers)).astype(np.int32)
    arrays = oracle.build_kmer_index(entry_kmers, nodes, 499)
    unique = np.unique(arrays.kmers)
    table = layout.build_table(unique, n_buckets=2 * layout.CHAIN_BLOCK)
    slots = layout.query_table(table, arrays.kmers)
    dev_index = ki.TpuKmerIndex(
        table=table,
        entry_slot=slots.astype(np.int32),
        entry_node=arrays.nodes,
        entry_frequency=arrays.frequencies,
        max_node_id=arrays.max_node_id(),
        n_unique=len(unique),
    )
    mesh = make_mesh(n_devices=4, index_parallel=2)
    config = MapperConfig(k=k, buf=1024, max_reads=64, read_len=L, revcomp=True)
    mapper = ShardedKmerMapper(dev_index, config, mesh)
    _run(mapper, reads, config)
    assert "plane" in mapper._steps
    queries = np.concatenate([fwd, oracle.revcomp_hash(fwd, k)])
    np.testing.assert_array_equal(
        mapper.node_counts(), oracle.map_kmers_to_index(arrays, queries)
    )


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_map_hashes_matches_oracle(shape):
    """ShardedKmerMapper.map_hashes — the KAGE pre-hashed library surface on
    a sharded index (batch over the data axis, each index shard counts its
    keys): counts bit-exact vs the oracle incl. duplicates and misses."""
    d, x = shape
    rng = np.random.default_rng(100 * d + x)
    k = 11
    reads, arrays, _ = _setup(rng, k)
    codes = [oracle.encode_string(r) for r in reads]
    read_kmers = oracle.kmer_hashes_ragged(
        np.concatenate(codes), np.array([len(c) for c in codes]), k
    )
    # duplicates, misses, and an awkward (non-pow2, non-multiple-of-D) length
    batch = np.concatenate(
        [
            rng.choice(read_kmers, 700),
            rng.integers(0, 1 << 62, 311, dtype=np.uint64),
        ]
    )
    mesh = make_mesh(n_devices=d * x, index_parallel=x)
    index = ki.TpuKmerIndex.from_arrays(arrays)
    config = MapperConfig(k=k, buf=1024, max_reads=64)
    mapper = ShardedKmerMapper(index, config, mesh)
    mapper.map_hashes(batch)
    mapper.map_hashes(batch[:37])  # second, differently-sized batch
    got = mapper.node_counts()
    want = oracle.map_kmers_to_index(
        arrays, np.concatenate([batch, batch[:37]])
    )
    np.testing.assert_array_equal(got, want)
    assert mapper.n_kmers_mapped == len(batch) + 37

    # mixing pre-hashed batches with packed chunk batches accumulates
    _run(mapper, reads, config)
    got2 = mapper.node_counts()
    want2 = want + oracle.map_kmers_to_index(arrays, read_kmers)
    np.testing.assert_array_equal(got2, want2)

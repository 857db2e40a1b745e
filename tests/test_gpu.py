"""Card-only tests: the compiled device steps on a GPU, bit-exact against
the oracle. They skip elsewhere; on a GPU machine run

    KMT_TESTS_ON_CARD=1 python -m pytest -m gpu tests/

(``chip_smoke.py`` runs them in a child process)."""
import numpy as np
import pytest

from kmer_mapper_tpu import oracle
from kmer_mapper_tpu.index import kmer_index as ki
from kmer_mapper_tpu.io import readers
from kmer_mapper_tpu.models.mapper import KmerMapper, MapperConfig

pytestmark = pytest.mark.gpu

K = 31


def _reads_and_index(seed, n_reads, lengths):
    rng = np.random.default_rng(seed)
    reads = ["".join(rng.choice(list("ACGTN"), n)) for n in lengths(rng, n_reads)]
    fwd = oracle.kmer_hashes_ragged(
        oracle.encode_string("".join(reads)), np.array([len(r) for r in reads]), K
    )
    pool = np.concatenate([fwd, oracle.revcomp_hash(fwd, K)])
    entries = np.concatenate(
        [rng.choice(pool, 3000), rng.integers(0, 1 << 62, 3000, dtype=np.uint64)]
    )
    nodes = rng.integers(0, 500, len(entries)).astype(np.int32)
    arrays = oracle.build_kmer_index(entries, nodes, 10007)
    return reads, fwd, arrays, ki.TpuKmerIndex.from_arrays(arrays)


def _packed(reads, config, read_len=0):
    chunk = readers.SequenceChunk(
        bases=np.frombuffer("".join(reads).encode(), np.uint8).copy(),
        read_starts=np.cumsum([0] + [len(r) for r in reads[:-1]]).astype(np.int64),
    )
    return list(readers.pack_for_device(
        iter([chunk]), config.buf, config.max_reads, config.k, read_len=read_len
    ))


def test_default_device_is_the_gpu(gpu):
    import jax

    assert jax.default_backend() == "gpu"
    assert gpu.platform == "gpu"


@pytest.mark.parametrize("accumulate", ["scatter", "sorted"])
@pytest.mark.parametrize("revcomp", [False, True])
def test_ragged_chunk_step_on_gpu(gpu, revcomp, accumulate):
    reads, fwd, arrays, index = _reads_and_index(
        1, 2000, lambda rng, n: rng.integers(10, 200, n)
    )
    config = MapperConfig(k=K, buf=1 << 18, max_reads=4096, revcomp=revcomp,
                          accumulate=accumulate)
    mapper = KmerMapper(index, config, device=gpu)
    for packed, lengths, nb, _, ninv in _packed(reads, config):
        mapper.map_chunk(packed, lengths, nb, ninv)
    queries = np.concatenate([fwd, oracle.revcomp_hash(fwd, K)]) if revcomp else fwd
    np.testing.assert_array_equal(
        mapper.node_counts(), oracle.map_kmers_to_index(arrays, queries)
    )
    assert mapper.n_kmers_mapped == len(fwd)


@pytest.mark.parametrize("revcomp", [False, True])
def test_plane_and_slice_steps_on_gpu(gpu, revcomp):
    L = 150
    reads, fwd, arrays, index = _reads_and_index(2, 3000, lambda rng, n: [L] * n)
    config = MapperConfig(k=K, buf=1 << 18, max_reads=4096, read_len=L, revcomp=revcomp)
    plane = KmerMapper(index, config, device=gpu)
    for packed, lengths, nb, _, ninv, strided in _packed(reads, config, read_len=L):
        assert strided
        plane.map_chunk(packed, lengths, nb, ninv, strided=True)
    sliced = KmerMapper(index, config, device=gpu)
    for packed, lengths, nb, _, ninv in _packed(reads, config):
        sliced.map_chunk(packed, lengths, nb, ninv)
    queries = np.concatenate([fwd, oracle.revcomp_hash(fwd, K)]) if revcomp else fwd
    expect = oracle.map_kmers_to_index(arrays, queries)
    np.testing.assert_array_equal(plane.node_counts(), expect)
    np.testing.assert_array_equal(sliced.node_counts(), expect)


def test_map_hashes_on_gpu(gpu):
    reads, fwd, arrays, index = _reads_and_index(3, 500, lambda rng, n: [100] * n)
    rng = np.random.default_rng(4)
    kmers = np.concatenate([rng.choice(fwd, 70_000), rng.integers(0, 1 << 62, 30_001, dtype=np.uint64)])
    mapper = KmerMapper(index, MapperConfig(k=K, buf=256, max_reads=16), device=gpu)
    mapper.map_hashes(kmers)
    np.testing.assert_array_equal(
        mapper.node_counts(), oracle.map_kmers_to_index(arrays, kmers)
    )
    np.testing.assert_array_equal(mapper.in_index(kmers), oracle.in_index(arrays, kmers))


def test_sharded_over_all_gpus(gpu):
    """Every local GPU as index shards: bit-exact against the oracle."""
    import jax

    from kmer_mapper_tpu.parallel import ShardedKmerMapper, batch_packed_chunks, make_mesh

    n = len(jax.devices())
    reads, fwd, arrays, index = _reads_and_index(
        5, 2000, lambda rng, k: rng.integers(10, 200, k)
    )
    mesh = make_mesh(n_devices=n, index_parallel=n)
    config = MapperConfig(k=K, buf=1 << 16, max_reads=2048, revcomp=True)
    mapper = ShardedKmerMapper(index, config, mesh)
    for batch in batch_packed_chunks(
        iter(_packed(reads, config)), mapper.n_data, config.packed_words, config.max_reads
    ):
        mapper.map_batch(*batch)
    np.testing.assert_array_equal(
        mapper.node_counts(),
        oracle.map_kmers_to_index(arrays, np.concatenate([fwd, oracle.revcomp_hash(fwd, K)])),
    )

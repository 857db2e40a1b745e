"""KmerMapper library-API parity tests: membership, state checkpointing."""
import numpy as np

from kmer_mapper_tpu import oracle
from kmer_mapper_tpu.index import kmer_index as ki
from kmer_mapper_tpu.models.mapper import KmerMapper, MapperConfig


def _setup(rng, n=400):
    entry_kmers = rng.integers(0, 1 << 62, n, dtype=np.uint64)
    entry_kmers = np.concatenate([entry_kmers, entry_kmers[:50]])  # dup entries
    nodes = rng.integers(0, 100, len(entry_kmers)).astype(np.int32)
    arrays = oracle.build_kmer_index(entry_kmers, nodes, 2003)
    return arrays, ki.TpuKmerIndex.from_arrays(arrays)


def test_in_index_matches_oracle():
    rng = np.random.default_rng(0)
    arrays, dev_index = _setup(rng)
    mapper = KmerMapper(dev_index, MapperConfig(k=31, buf=256, max_reads=16))
    queries = np.concatenate(
        [rng.choice(arrays.kmers, 300), rng.integers(0, 1 << 62, 200, dtype=np.uint64)]
    )
    got = mapper.in_index(queries)
    expect = oracle.in_index(arrays, queries)
    np.testing.assert_array_equal(got, expect)


def test_save_load_state_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    arrays, dev_index = _setup(rng)
    config = MapperConfig(k=31, buf=256, max_reads=16)
    mapper = KmerMapper(dev_index, config)
    q1 = rng.choice(arrays.kmers, 500)
    q2 = rng.choice(arrays.kmers, 700)
    mapper.map_hashes(q1)
    path = tmp_path / "state.npz"
    mapper.save_state(path)

    resumed = KmerMapper(dev_index, config)
    resumed.load_state(path)
    resumed.map_hashes(q2)

    full = KmerMapper(dev_index, config)
    full.map_hashes(np.concatenate([q1, q2]))
    np.testing.assert_array_equal(resumed.node_counts(), full.node_counts())
    assert resumed.n_kmers_mapped == full.n_kmers_mapped

"""Bench-to-production coherence: the mapper ``bench.py`` measures is
mechanically the one ``pipeline.map_file`` builds for the same index, read
length and device buffer, on whatever backend the tests run (nothing
executes on a device — KmerMapper's jit is lazy)."""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # bench.py

from kmer_mapper_tpu import pipeline  # noqa: E402
from kmer_mapper_tpu.index import kmer_index as ki  # noqa: E402

READ_LEN = 151
K = 31
BUF = 64 << 20  # bench.py's default BENCH_BUF_MI


def _small_index(rng, n=60_000):
    kmers = np.unique(rng.integers(0, 1 << 62, n, dtype=np.uint64))
    nodes = rng.integers(0, 1000, len(kmers)).astype(np.int32)
    return ki.TpuKmerIndex.from_entries(kmers, nodes)


def _fasta(tmp_path, rng, lengths):
    path = tmp_path / "reads.fa"
    with open(path, "w") as f:
        for i, n in enumerate(lengths):
            f.write(f">r{i}\n{''.join(rng.choice(list('ACGT'), n))}\n")
    return str(path)


def _production_config(index, reads, chunk_size):
    mapper, chunks = pipeline.make_mapper_and_chunks(
        index, reads, K, chunk_size=chunk_size,
        map_reverse_complements=False, accumulate="scatter",
    )
    for _ in chunks:  # drain so the prefetch machinery exits cleanly
        pass
    return mapper.config


def test_bench_config_equals_map_file_config(tmp_path):
    """Fixed 151 bp reads: bench's plane-step config is map_file's."""
    import bench

    rng = np.random.default_rng(3)
    index = _small_index(rng)
    reads = _fasta(tmp_path, rng, [READ_LEN] * 64)
    bench_mapper = bench.resolve_bench_mapper(index, READ_LEN, buf=BUF, k=K)
    assert bench_mapper.config == _production_config(index, reads, BUF)
    assert bench_mapper.config.read_len == READ_LEN


def test_bench_ragged_config_equals_map_file_config(tmp_path):
    """BENCH_RAGGED=1 (mixed-length reads): bench's ragged-step config is
    the one map_file picks for a mixed-length file."""
    import bench

    rng = np.random.default_rng(4)
    index = _small_index(rng)
    reads = _fasta(tmp_path, rng, rng.integers(READ_LEN - 50, READ_LEN + 51, 64))
    bench_mapper = bench.resolve_bench_mapper(index, 0, buf=BUF, k=K)
    assert bench_mapper.config == _production_config(index, reads, BUF)
    assert bench_mapper.config.read_len == 0

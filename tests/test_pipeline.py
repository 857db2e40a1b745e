"""End-to-end pipeline + CLI tests: file -> node counts, bit-exact vs oracle."""
import gzip

import numpy as np
import pytest

from kmer_mapper_tpu import oracle, pipeline
from kmer_mapper_tpu.cli import run_argument_parser
from kmer_mapper_tpu.index import kmer_index as ki


def _make_reads(rng, n=120, lo=20, hi=90):
    return ["".join(rng.choice(list("ACGT"), rng.integers(lo, hi))) for _ in range(n)]


def _oracle_counts(arrays, reads, k, max_frequency=1000, revcomp=False):
    codes = [oracle.encode_string(r.upper().replace("N", "A")) for r in reads]
    hashes = oracle.kmer_hashes_ragged(
        np.concatenate(codes), np.array([len(c) for c in codes]), k
    )
    if revcomp:
        hashes = np.concatenate([hashes, oracle.revcomp_hash(hashes, k)])
    return oracle.map_kmers_to_index(arrays, hashes, max_frequency=max_frequency)


def _index_from_reads(rng, reads, k, n_nodes=80, extra=50):
    codes = [oracle.encode_string(r) for r in reads]
    read_kmers = oracle.kmer_hashes_ragged(
        np.concatenate(codes), np.array([len(c) for c in codes]), k
    )
    mask = np.uint64(4**k - 1) if k < 32 else np.uint64(-1)
    entry_kmers = np.concatenate(
        [
            rng.choice(read_kmers, 150),
            rng.integers(0, 1 << 62, extra, dtype=np.uint64) & mask,
        ]
    )
    nodes = rng.integers(0, n_nodes, len(entry_kmers)).astype(np.int32)
    return oracle.build_kmer_index(entry_kmers, nodes, 997)


def _write_fasta(path, reads):
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    return str(path)


@pytest.mark.parametrize("k", [5, 31])
def test_map_file_fasta_matches_oracle(tmp_path, k):
    rng = np.random.default_rng(k)
    reads = _make_reads(rng)
    arrays = _index_from_reads(rng, reads, k)
    reads_path = _write_fasta(tmp_path / "reads.fa", reads)
    got = pipeline.map_file(
        ki.TpuKmerIndex.from_arrays(arrays), reads_path, k=k, chunk_size=1 << 14
    )
    np.testing.assert_array_equal(got, _oracle_counts(arrays, reads, k))


def test_map_file_small_chunks_many_buffers(tmp_path):
    """Tiny chunk size forces many device buffers + carry-over paths."""
    k = 11
    rng = np.random.default_rng(99)
    reads = _make_reads(rng, n=300)
    arrays = _index_from_reads(rng, reads, k)
    reads_path = _write_fasta(tmp_path / "reads.fa", reads)
    got = pipeline.map_file(
        ki.TpuKmerIndex.from_arrays(arrays), reads_path, k=k, chunk_size=1 << 16
    )
    np.testing.assert_array_equal(got, _oracle_counts(arrays, reads, k))


def test_map_file_fastq_gz_with_n_bases(tmp_path):
    k = 7
    rng = np.random.default_rng(7)
    reads = _make_reads(rng, n=80)
    # sprinkle N's: they must count as A (reference N->A substitution)
    reads = [r[:3] + "N" + r[4:] if len(r) > 5 else r for r in reads]
    arrays = _index_from_reads(rng, [r.replace("N", "A") for r in reads], k)
    path = tmp_path / "reads.fq.gz"
    with gzip.open(path, "wt") as f:
        f.write("".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(reads)))
    got = pipeline.map_file(
        ki.TpuKmerIndex.from_arrays(arrays), str(path), k=k, chunk_size=1 << 14
    )
    np.testing.assert_array_equal(got, _oracle_counts(arrays, reads, k))


def test_map_file_revcomp(tmp_path):
    k = 9
    rng = np.random.default_rng(11)
    reads = _make_reads(rng, n=60)
    arrays = _index_from_reads(rng, reads, k)
    reads_path = _write_fasta(tmp_path / "reads.fa", reads)
    got = pipeline.map_file(
        ki.TpuKmerIndex.from_arrays(arrays),
        reads_path,
        k=k,
        chunk_size=1 << 14,
        map_reverse_complements=True,
    )
    np.testing.assert_array_equal(got, _oracle_counts(arrays, reads, k, revcomp=True))


def test_map_sequences_programmatic():
    k = 5
    rng = np.random.default_rng(13)
    reads = _make_reads(rng, n=30)
    arrays = _index_from_reads(rng, reads, k)
    got = pipeline.map_sequences(ki.TpuKmerIndex.from_arrays(arrays), reads, k=k)
    np.testing.assert_array_equal(got, _oracle_counts(arrays, reads, k))


def test_cli_map_end_to_end(tmp_path):
    k = 7
    rng = np.random.default_rng(17)
    reads = _make_reads(rng, n=50)
    arrays = _index_from_reads(rng, reads, k)
    index_path = tmp_path / "index.npz"
    ki.save_reference_npz(index_path, arrays)
    reads_path = _write_fasta(tmp_path / "reads.fa", reads)
    out = tmp_path / "counts"
    run_argument_parser(
        ["map", "-i", str(index_path), "-f", reads_path, "-o", str(out), "-k", str(k)]
    )
    got = np.load(str(out) + ".npy")
    np.testing.assert_array_equal(got, _oracle_counts(arrays, reads, k))


def test_cli_convert_index_then_map(tmp_path):
    k = 7
    rng = np.random.default_rng(19)
    reads = _make_reads(rng, n=40)
    arrays = _index_from_reads(rng, reads, k)
    ref_path = tmp_path / "index.npz"
    ki.save_reference_npz(ref_path, arrays)
    prebuilt_path = tmp_path / "index.tpuidx.npz"
    run_argument_parser(["convert-index", "-i", str(ref_path), "-o", str(prebuilt_path)])
    reads_path = _write_fasta(tmp_path / "reads.fa", reads)
    out = tmp_path / "counts"
    run_argument_parser(
        ["map", "-i", str(prebuilt_path), "-f", reads_path, "-o", str(out), "-k", str(k)]
    )
    got = np.load(str(out) + ".npy")
    np.testing.assert_array_equal(got, _oracle_counts(arrays, reads, k))


def test_cli_max_hits_per_kmer_flag(tmp_path):
    k = 5
    kmers = np.array([7, 9], dtype=np.uint64)
    nodes = np.array([0, 1], dtype=np.int32)
    arrays = oracle.build_kmer_index(kmers, nodes, 101, frequencies=np.array([1, 1001]))
    index_path = tmp_path / "index.npz"
    ki.save_reference_npz(index_path, arrays)
    # read whose kmers are exactly the two index kmers
    seq = oracle.decode_to_string(
        [(7 >> (2 * i)) & 3 for i in range(k)]
    )
    seq2 = oracle.decode_to_string([(9 >> (2 * i)) & 3 for i in range(k)])
    reads_path = _write_fasta(tmp_path / "reads.fa", [seq, seq2])
    out = tmp_path / "counts"
    run_argument_parser(
        ["map", "-i", str(index_path), "-f", reads_path, "-o", str(out), "-k", str(k)]
    )
    np.testing.assert_array_equal(np.load(str(out) + ".npy"), [1, 0])
    run_argument_parser(
        ["map", "-i", str(index_path), "-f", reads_path, "-o", str(out), "-k", str(k),
         "-I", "2000"]
    )
    np.testing.assert_array_equal(np.load(str(out) + ".npy"), [1, 1])


def test_cli_requires_index(tmp_path, capsys):
    reads_path = _write_fasta(tmp_path / "r.fa", ["ACGT"])
    with pytest.raises(SystemExit):
        run_argument_parser(["map", "-f", reads_path, "-o", str(tmp_path / "o")])


def test_map_file_sharded_matches_oracle(tmp_path):
    k = 9
    rng = np.random.default_rng(23)
    reads = _make_reads(rng, n=150)
    arrays = _index_from_reads(rng, reads, k)
    reads_path = _write_fasta(tmp_path / "reads.fa", reads)
    got = pipeline.map_file_sharded(
        ki.TpuKmerIndex.from_arrays(arrays),
        reads_path,
        k=k,
        chunk_size=1 << 16,
        n_devices=4,
        index_parallel=2,
    )
    np.testing.assert_array_equal(got, _oracle_counts(arrays, reads, k))


def test_cli_multi_device(tmp_path):
    k = 7
    rng = np.random.default_rng(29)
    reads = _make_reads(rng, n=60)
    arrays = _index_from_reads(rng, reads, k)
    index_path = tmp_path / "index.npz"
    ki.save_reference_npz(index_path, arrays)
    reads_path = _write_fasta(tmp_path / "reads.fa", reads)
    out = tmp_path / "counts"
    run_argument_parser(
        ["map", "-i", str(index_path), "-f", reads_path, "-o", str(out),
         "-k", str(k), "--n-devices", "8", "--index-parallel", "2"]
    )
    np.testing.assert_array_equal(
        np.load(str(out) + ".npy"), _oracle_counts(arrays, reads, k)
    )


def test_map_file_empty_fasta(tmp_path):
    k = 7
    rng = np.random.default_rng(31)
    arrays = _index_from_reads(rng, _make_reads(rng, n=5), k)
    path = tmp_path / "empty.fa"
    path.write_text("")
    got = pipeline.map_file(ki.TpuKmerIndex.from_arrays(arrays), str(path), k=k)
    np.testing.assert_array_equal(got, 0)
    assert got.shape == (arrays.max_node_id() + 1,)


def test_map_file_reads_shorter_than_k(tmp_path):
    k = 31
    rng = np.random.default_rng(37)
    arrays = _index_from_reads(rng, _make_reads(rng, n=5, lo=40, hi=60), k)
    path = _write_fasta(tmp_path / "short.fa", ["ACGT", "GG", "ACGTACGT"])
    got = pipeline.map_file(ki.TpuKmerIndex.from_arrays(arrays), str(path), k=k)
    np.testing.assert_array_equal(got, 0)


def test_cli_k_out_of_range(tmp_path):
    rng = np.random.default_rng(41)
    arrays = _index_from_reads(rng, _make_reads(rng, n=5), 7)
    index_path = tmp_path / "index.npz"
    ki.save_reference_npz(index_path, arrays)
    reads_path = _write_fasta(tmp_path / "r.fa", ["ACGTACGT"])
    with pytest.raises(SystemExit):
        run_argument_parser(
            ["map", "-i", str(index_path), "-f", reads_path, "-o", str(tmp_path / "o"),
             "-k", "40"]
        )


def test_strict_bases_raises(tmp_path):
    """--strict-bases reproduces bionumpy DNAEncoding's raise-on-invalid
    (SURVEY §3.4); N stays legal (the reference substitutes N->A upstream)."""
    rng = np.random.default_rng(11)
    reads = _make_reads(rng, n=20)
    reads[3] = reads[3][:5] + "X" + reads[3][6:]  # one invalid byte
    fixed = [r.replace("X", "A") for r in reads]
    arrays = _index_from_reads(rng, fixed, 5)
    reads_path = _write_fasta(tmp_path / "bad.fa", reads)
    index = ki.TpuKmerIndex.from_arrays(arrays)
    with pytest.raises(ValueError, match="invalid"):
        pipeline.map_file(index, reads_path, k=5, strict_bases=True, progress=False)
    # default mode still maps (X encoded as A)
    got = pipeline.map_file(index, reads_path, k=5, progress=False)
    np.testing.assert_array_equal(got, _oracle_counts(arrays, fixed, 5))
    # N alone must not trip strict mode
    reads_n = [r[:2] + "N" + r[3:] for r in fixed[:5]]
    arrays_n = _index_from_reads(rng, [r.replace("N", "A") for r in reads_n], 5)
    path_n = _write_fasta(tmp_path / "n.fa", reads_n)
    got_n = pipeline.map_file(
        ki.TpuKmerIndex.from_arrays(arrays_n), path_n, k=5, strict_bases=True, progress=False
    )
    np.testing.assert_array_equal(got_n, _oracle_counts(arrays_n, reads_n, 5))


def test_map_file_uniform_reads_picks_fixed_read_len(tmp_path):
    """Uniform-length reads (the Illumina case) auto-select the fixed
    read_len step; counts stay bit-exact vs the oracle."""
    rng = np.random.default_rng(41)
    k, L = 9, 40
    reads = ["".join(rng.choice(list("ACGT"), L)) for _ in range(150)]
    arrays = _index_from_reads(rng, reads, k)
    index = ki.TpuKmerIndex.from_arrays(arrays)
    reads_path = _write_fasta(tmp_path / "uniform.fa", reads)
    mapper, chunks = pipeline.make_mapper_and_chunks(
        index, reads_path, k=k, chunk_size=1 << 14,
        map_reverse_complements=False, accumulate="scatter",
    )
    assert mapper.config.read_len == L
    for packed, lengths, n_bases, _, n_invalid, strided in chunks:
        assert strided  # peek-detected read_len: packed for the plane step
        mapper.map_chunk(packed, lengths, n_bases, n_invalid, strided=strided)
    assert mapper._ragged_step is None  # every chunk took the fast path
    np.testing.assert_array_equal(
        mapper.node_counts(), _oracle_counts(arrays, reads, k)
    )


def test_map_file_mixed_reads_stays_ragged(tmp_path):
    rng = np.random.default_rng(42)
    k = 9
    reads = _make_reads(rng, n=100)
    arrays = _index_from_reads(rng, reads, k)
    index = ki.TpuKmerIndex.from_arrays(arrays)
    reads_path = _write_fasta(tmp_path / "mixed.fa", reads)
    mapper, _ = pipeline.make_mapper_and_chunks(
        index, reads_path, k=k, chunk_size=1 << 14,
        map_reverse_complements=False, accumulate="scatter",
    )
    assert mapper.config.read_len == 0
    got = pipeline.map_file(index, reads_path, k=k, chunk_size=1 << 14)
    np.testing.assert_array_equal(got, _oracle_counts(arrays, reads, k))


def test_map_file_sharded_uniform_reads_fixed_path(tmp_path):
    """Uniform-length reads through the sharded mesh path auto-select the
    fixed read_len step; counts stay bit-exact vs oracle."""
    k, L = 9, 36
    rng = np.random.default_rng(31)
    reads = ["".join(rng.choice(list("ACGT"), L)) for _ in range(160)]
    arrays = _index_from_reads(rng, reads, k)
    reads_path = _write_fasta(tmp_path / "uniform.fa", reads)
    got = pipeline.map_file_sharded(
        ki.TpuKmerIndex.from_arrays(arrays),
        reads_path,
        k=k,
        chunk_size=1 << 16,
        n_devices=4,
        index_parallel=2,
    )
    np.testing.assert_array_equal(got, _oracle_counts(arrays, reads, k))


def test_sharded_mapper_ragged_batch_falls_back(tmp_path):
    """A sharded mapper compiled with read_len must take the ragged twin for
    batches that break uniformity and still count exactly."""
    import jax

    from kmer_mapper_tpu.models.mapper import default_config
    from kmer_mapper_tpu.parallel import (
        ShardedKmerMapper, batch_packed_chunks, make_mesh,
    )
    from kmer_mapper_tpu.io import readers

    k, L = 9, 30
    rng = np.random.default_rng(33)
    uniform = ["".join(rng.choice(list("ACGT"), L)) for _ in range(60)]
    ragged = _make_reads(rng, n=60)
    arrays = _index_from_reads(rng, uniform + ragged, k)
    index = ki.TpuKmerIndex.from_arrays(arrays)
    mesh = make_mesh(n_devices=4, index_parallel=2)
    config = default_config(k=k, buf=1 << 13, max_reads=256, read_len=L)
    mapper = ShardedKmerMapper(index, config, mesh)
    for reads in (uniform, ragged):
        flat = "".join(reads)
        chunk = readers.SequenceChunk(
            bases=np.frombuffer(flat.encode(), dtype=np.uint8),
            read_starts=np.cumsum([0] + [len(s) for s in reads[:-1]]).astype(np.int64),
        )
        packed = readers.pack_for_device(iter([chunk]), config.buf, config.max_reads, k)
        for batch in batch_packed_chunks(packed, mapper.n_data, config.packed_words,
                                         config.max_reads):
            mapper.map_batch(*batch)
    assert set(mapper._steps) == {"plane", "ragged"}
    np.testing.assert_array_equal(
        mapper.node_counts(), _oracle_counts(arrays, uniform + ragged, k)
    )


@pytest.mark.parametrize(
    "chunk_size,buf",
    [(1000, 1 << 16), (2_500_000, 2_506_752), (1 << 30, 64 << 20)],
)
def test_device_buffer_policy(chunk_size, buf):
    """One buffer policy on every backend: the reference's chunk size,
    clamped to [64 Ki, 64 Mi] bases and rounded up to 8 Ki."""
    assert pipeline.device_buffer(chunk_size) == buf
    assert buf % (1 << 13) == 0


def test_peek_read_len(tmp_path):
    """_peek_read_len detects uniform-length files from the first records
    (gz included) and returns 0 for ragged/short input."""
    rng = np.random.default_rng(51)
    L = 44
    uniform = ["".join(rng.choice(list("ACGT"), L)) for _ in range(30)]
    p1 = _write_fasta(tmp_path / "u.fa", uniform)
    assert pipeline._peek_read_len(p1, 9) == L
    assert pipeline._peek_read_len(p1, L + 1) == 0  # shorter than k
    ragged = _make_reads(rng, n=30)
    p2 = _write_fasta(tmp_path / "r.fa", ragged)
    assert pipeline._peek_read_len(p2, 9) == 0
    import gzip

    p3 = tmp_path / "u.fq.gz"
    with gzip.open(p3, "wt") as f:
        for i, s in enumerate(uniform):
            f.write(f"@r{i}\n{s}\n+\n{'F' * L}\n")
    assert pipeline._peek_read_len(str(p3), 9) == L
    # a peek window cutting a record mid-way still detects from the complete
    # prefix records
    assert pipeline._peek_read_len(p1, 9, peek_bytes=3 * (L + 5) + 7) == L
    assert pipeline._peek_read_len(str(tmp_path / "missing.fa"), 9) == 0


def test_map_file_packs_strided_from_buffer_one(tmp_path):
    """On fixed-length reads the frame+pack pass emits the word-plane strided
    layout directly (peek-detected read_len; no restride pass) — counts
    bit-exact vs oracle."""
    rng = np.random.default_rng(52)
    k, L = 16, 31
    reads = ["".join(rng.choice(list("ACGTN"), L)) for _ in range(90)]
    arrays = _index_from_reads(rng, [r.replace("N", "A") for r in reads], k)
    index = ki.TpuKmerIndex.from_arrays(arrays)
    path = _write_fasta(tmp_path / "u.fa", reads)
    mapper, chunks = pipeline.make_mapper_and_chunks(
        index, path, k=k, chunk_size=1 << 11,
        map_reverse_complements=False, accumulate="scatter",
    )
    assert mapper.config.read_len == L
    tuples = list(chunks)
    assert tuples and all(t[5] for t in tuples)  # strided from buffer one
    for packed, lengths, nb, nr, ninv, strided in tuples:
        mapper.map_chunk(packed, lengths, nb, ninv, strided=strided)
    np.testing.assert_array_equal(
        mapper.node_counts(), _oracle_counts(arrays, reads, k)
    )

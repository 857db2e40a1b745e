"""Fixed-read-length word-plane path: strided packing, restride, plane hash,
and the plane chunk step — all bit-exact vs the continuous path and the
numpy oracle.

The plane path (``hashing.plane_hash_mixed`` + the gather probe) replaces the
interleaved rolling hash + window slice with contiguous word-plane
shift/ORs over stride-padded reads. Counting semantics must be identical to
the ragged/continuous paths; these tests pin that.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from kmer_mapper_tpu import oracle, pipeline
from kmer_mapper_tpu.index import kmer_index as ki
from kmer_mapper_tpu.io import readers
from kmer_mapper_tpu.models.mapper import KmerMapper, MapperConfig
from kmer_mapper_tpu.ops import hashing
from kmer_mapper_tpu.ops.u32hash import feistel_mix

rng = np.random.default_rng(7)


def _uniform_reads(n, L, with_n=False):
    alphabet = list("ACGT" + ("N" if with_n else ""))
    return ["".join(rng.choice(alphabet, L)) for _ in range(n)]


def _chunk_from_reads(reads):
    flat = "".join(reads)
    starts = np.cumsum([0] + [len(r) for r in reads[:-1]]).astype(np.int64)
    return readers.SequenceChunk(
        bases=np.frombuffer(flat.encode(), np.uint8).copy(), read_starts=starts
    )


def _pack(reads, buf, max_reads, k, read_len=0):
    return list(
        readers.pack_for_device(
            iter([_chunk_from_reads(reads)]), buf, max_reads, k, read_len=read_len
        )
    )


def _index_for(reads, k, n_nodes=60):
    """(reference-layout oracle arrays, device TpuKmerIndex) for the reads."""
    codes = [oracle.encode_string(r.upper().replace("N", "A")) for r in reads]
    kmers = oracle.kmer_hashes_ragged(
        np.concatenate(codes), np.array([len(c) for c in codes]), k
    )
    mask = np.uint64(4**k - 1)
    entries = np.unique(
        np.concatenate(
            [kmers[:: max(1, len(kmers) // 64)],
             rng.integers(0, 1 << min(62, 2 * k), 64, dtype=np.uint64) & mask]
        )
    )
    nodes = rng.integers(0, n_nodes, len(entries)).astype(np.int32)
    arrays = oracle.build_kmer_index(entries, nodes, 997)
    return arrays, ki.TpuKmerIndex.from_arrays(arrays)


def _oracle_node_counts(arrays, reads, k, revcomp=False):
    codes = [oracle.encode_string(r.upper().replace("N", "A")) for r in reads]
    hashes = oracle.kmer_hashes_ragged(
        np.concatenate(codes), np.array([len(c) for c in codes]), k
    )
    if revcomp:
        hashes = np.concatenate([hashes, oracle.revcomp_hash(hashes, k)])
    return oracle.map_kmers_to_index(arrays, hashes)


@pytest.mark.parametrize("L,k", [(51, 31), (48, 31), (37, 13), (16, 11)])
def test_strided_pack_matches_restride(L, k):
    reads = _uniform_reads(40, L, with_n=True)
    buf, max_reads = 1 << 12, 256
    direct = _pack(reads, buf, max_reads, k, read_len=L)
    cont = _pack(reads, buf, max_reads, k)
    assert len(direct) == len(cont)
    for d, c in zip(direct, cont):
        packed_d, lengths_d, nb_d, nr_d, ninv_d, strided = d
        packed_c, lengths_c, nb_c, nr_c, ninv_c = c
        assert strided
        assert (nb_d, nr_d, ninv_d) == (nb_c, nr_c, ninv_c)
        np.testing.assert_array_equal(lengths_d, lengths_c)
        restrided = readers.restride_packed(
            packed_c, nr_c, L, readers.strided_rows(buf, L)
        )
        np.testing.assert_array_equal(packed_d, restrided)


@pytest.mark.parametrize("L", [151, 48, 37, 16])
def test_restride_native_matches_numpy(L, monkeypatch):
    from kmer_mapper_tpu.io import native as native_mod

    if not native_mod.available():
        pytest.skip("native loader unavailable")
    reads = _uniform_reads(50, L, with_n=True)
    buf = 1 << 13
    (packed_c, lengths, nb, nr, _), = _pack(reads, buf, 256, 15)
    rows = readers.strided_rows(buf, L)
    nat = native_mod.restride_native(packed_c, nr, L, rows)
    monkeypatch.setattr(native_mod, "available", lambda: False)
    ref = readers.restride_packed(packed_c, nr, L, rows)
    np.testing.assert_array_equal(nat, ref)


@pytest.mark.parametrize("L,k", [(51, 31), (48, 31), (37, 13)])
def test_plane_hash_matches_sorted_queries(L, k):
    """The plane hash emits the same multiset of mixed window words as the
    rolling hash + static slice + feistel_mix over continuous packing; rows
    past ``n_reads`` are the sentinel pattern."""
    reads = _uniform_reads(30, L)
    buf, max_reads = 1 << 12, 256
    (packed_s, lengths, nb, nr, _, strided), = _pack(reads, buf, max_reads, k, read_len=L)
    assert strided
    (packed_c, *_), = _pack(reads, buf, max_reads, k)
    _, index = _index_for(reads, k)
    seed = index.table.seed
    W = L - k + 1

    # continuous path: rolling hash + static slice + mix of the valid rows
    R = buf // L
    lo, hi = hashing.rolling_kmer_hash_packed(jnp.asarray(packed_c), k)
    lo = lo[: R * L].reshape(R, L)[:, :W][:nr].reshape(-1)
    hi = hi[: R * L].reshape(R, L)[:, :W][:nr].reshape(-1)
    old_lo, old_hi = feistel_mix(lo, hi, seed=seed, xp=jnp)
    old = np.sort(np.asarray(old_lo).astype(np.uint64) << np.uint64(32)
                  | np.asarray(old_hi).astype(np.uint64))

    m_lo, m_hi = hashing.plane_hash_mixed(jnp.asarray(packed_s), k, L, jnp.int32(nr), seed)
    m_lo, m_hi = np.asarray(m_lo), np.asarray(m_hi)
    assert len(m_lo) == W * readers.strided_rows(buf, L)
    real = ~((m_lo == hashing.INVALID_WORD) & (m_hi == hashing.INVALID_WORD))
    assert real.sum() == nr * W
    new = np.sort(m_lo[real].astype(np.uint64) << np.uint64(32)
                  | m_hi[real].astype(np.uint64))
    np.testing.assert_array_equal(old, new)


@pytest.mark.parametrize("revcomp", [False, True])
def test_plane_chunk_step_counts_match_oracle(revcomp):
    L, k = 51, 31
    reads = _uniform_reads(60, L, with_n=True)
    arrays, index = _index_for(reads, k)
    config = MapperConfig(
        k=k, buf=1 << 12, max_reads=256, read_len=L, revcomp=revcomp,
    )
    mapper = KmerMapper(index, config)
    for packed, lengths, nb, nr, ninv, strided in _pack(
        reads, config.buf, config.max_reads, k, read_len=L
    ):
        assert strided
        mapper.map_chunk(packed, lengths, nb, ninv, strided=True)
    assert mapper.n_kmers_mapped == len(reads) * (L - k + 1)
    np.testing.assert_array_equal(
        mapper.node_counts(), _oracle_node_counts(arrays, reads, k, revcomp=revcomp)
    )

    # identical result through the continuous (slice) fast path
    mapper2 = KmerMapper(index, config)
    for packed, lengths, nb, nr, ninv in _pack(
        reads, config.buf, config.max_reads, k
    ):
        mapper2.map_chunk(packed, lengths, nb, ninv)
    np.testing.assert_array_equal(mapper2.node_counts(), mapper.node_counts())


def test_strided_chunks_generator_mixed_lengths_fallback():
    """Uniform buffers restride + take the plane step; a buffer containing an
    off-length read passes through continuous and takes the ragged step —
    counts equal the oracle either way."""
    L, k = 37, 21
    reads = _uniform_reads(50, L) + ["ACGT" * 20] + _uniform_reads(50, L)
    arrays, index = _index_for(reads, k)
    config = MapperConfig(k=k, buf=1 << 11, max_reads=64, read_len=L)
    mapper = KmerMapper(index, config)
    tuples = list(
        pipeline._strided_chunks(
            iter(_pack(reads, config.buf, config.max_reads, k)), config
        )
    )
    flags = [t[5] for t in tuples]
    assert any(flags) and not all(flags)
    for packed, lengths, nb, nr, ninv, strided in tuples:
        mapper.map_chunk(packed, lengths, nb, ninv, strided=strided)
    np.testing.assert_array_equal(
        mapper.node_counts(), _oracle_node_counts(arrays, reads, k)
    )


def test_map_file_plane_end_to_end(tmp_path):
    """pipeline.map_file on fixed-length reads packs strided from buffer one
    and drives the plane step — vs oracle."""
    L, k = 31, 16
    reads = _uniform_reads(80, L, with_n=True)
    arrays, index = _index_for(reads, k)
    path = tmp_path / "reads.fa"
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    got = pipeline.map_file(index, str(path), k=k, chunk_size=1 << 11, progress=False)
    np.testing.assert_array_equal(got, _oracle_node_counts(arrays, reads, k))

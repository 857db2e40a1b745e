"""Index layer tests: table build/query, npz loaders, TpuKmerIndex finalization."""
import io
import zipfile

import numpy as np
import pytest

from kmer_mapper_tpu import oracle
from kmer_mapper_tpu.index import kmer_index as ki
from kmer_mapper_tpu.index import layout


def test_table_build_and_query_roundtrip():
    rng = np.random.default_rng(1)
    keys = np.unique(rng.integers(0, 1 << 62, 5000, dtype=np.uint64))
    table = layout.build_table(keys)
    slots = layout.query_table(table, keys)
    assert (slots >= 0).all()
    # slots are distinct and store the right keys
    assert len(np.unique(slots)) == len(keys)
    # stored words are bijectively mixed; unmixing recovers the raw keys
    from kmer_mapper_tpu.ops.u32hash import feistel_unmix, join_u64

    m_lo, m_hi = table.key_words()
    lo, hi = feistel_unmix(m_lo[slots], m_hi[slots], seed=table.seed)
    np.testing.assert_array_equal(join_u64(lo, hi), keys)
    # absent keys return -1
    absent = np.setdiff1d(rng.integers(0, 1 << 62, 1000, dtype=np.uint64), keys)
    np.testing.assert_array_equal(layout.query_table(table, absent), -1)


def test_table_build_high_load_chaining():
    rng = np.random.default_rng(2)
    keys = np.unique(rng.integers(0, 1 << 62, 4096, dtype=np.uint64))
    # ~85% load factor forces collision chains (wrapping inside chain blocks)
    n_buckets = layout._next_pow2(int(np.ceil(len(keys) / layout.BUCKET_KEYS / 0.85)))
    table = layout.build_table(keys, n_buckets=n_buckets)
    assert table.max_probe > 1
    slots = layout.query_table(table, keys)
    assert (slots >= 0).all()
    assert len(np.unique(slots)) == len(keys)


def test_chain_next_wraps_within_block():
    n_buckets = 4 * layout.CHAIN_BLOCK
    b = np.array([0, layout.CHAIN_BLOCK - 1, layout.CHAIN_BLOCK, n_buckets - 1])
    stepped = layout.chain_next(b, 1, n_buckets)
    np.testing.assert_array_equal(
        stepped, [1, 0, layout.CHAIN_BLOCK + 1, n_buckets - layout.CHAIN_BLOCK]
    )
    # small tables wrap within the whole table
    np.testing.assert_array_equal(layout.chain_next(np.array([7]), 1, 8), [0])


def test_reference_npz_roundtrip(tmp_path):
    index = ki.build_toy_index(n_unique=500, k=31, n_nodes=200, seed=3)
    path = tmp_path / "index.npz"
    ki.save_reference_npz(path, index)
    loaded = ki.load_reference_npz(path)
    np.testing.assert_array_equal(loaded.kmers, index.kmers)
    np.testing.assert_array_equal(loaded.nodes, index.nodes)
    assert loaded.modulo == index.modulo


def test_reference_npz_underscore_fields_and_missing_frequencies(tmp_path):
    index = ki.build_toy_index(n_unique=100, k=21, n_nodes=50, seed=4)
    path = tmp_path / "minimal_index.npz"
    np.savez(
        path,
        _hashes_to_index=index.hashes_to_index,
        _n_kmers=index.n_kmers,
        _kmers=index.kmers,
        _nodes=index.nodes,
        _modulo=np.uint64(index.modulo),
        _ref_offsets=np.zeros(len(index.kmers), dtype=np.uint64),  # must be dropped
    )
    loaded = ki.load_reference_npz(path)
    np.testing.assert_array_equal(loaded.frequencies, 1)
    np.testing.assert_array_equal(loaded.kmers, index.kmers)


def test_tpu_index_node_counts_match_oracle_probe():
    index = ki.build_toy_index(n_unique=2000, k=31, n_nodes=500, seed=5)
    dev_index = ki.TpuKmerIndex.from_arrays(index)
    rng = np.random.default_rng(6)
    queries = np.concatenate(
        [rng.choice(index.kmers, 5000), rng.integers(0, 1 << 62, 1000, dtype=np.uint64)]
    )
    # count on the "device" structure via the host query path
    slots = layout.query_table(dev_index.table, queries)
    slot_counts = np.bincount(slots[slots >= 0], minlength=dev_index.table.n_slots)
    got = dev_index.node_counts(slot_counts)
    expect = oracle.map_kmers_to_index(index, queries)
    np.testing.assert_array_equal(got, expect)


def test_tpu_index_frequency_filter():
    kmers = np.array([5, 9, 13], dtype=np.uint64)
    nodes = np.array([0, 1, 2], dtype=np.int32)
    freqs = np.array([1, 1001, 1000], dtype=np.uint16)
    arrays = oracle.build_kmer_index(kmers, nodes, 101, frequencies=freqs)
    dev_index = ki.TpuKmerIndex.from_arrays(arrays)
    slots = layout.query_table(dev_index.table, kmers)
    slot_counts = np.bincount(slots, minlength=dev_index.table.n_slots)
    np.testing.assert_array_equal(dev_index.node_counts(slot_counts), [1, 0, 1])
    np.testing.assert_array_equal(dev_index.node_counts(slot_counts, max_frequency=2000), [1, 1, 1])


def test_tpuidx_file_roundtrip(tmp_path):
    index = ki.build_toy_index(n_unique=300, k=31, n_nodes=100, seed=7)
    dev_index = ki.TpuKmerIndex.from_arrays(index)
    path = tmp_path / "index.tpuidx.npz"
    dev_index.to_file(path)
    loaded = ki.load_index(path)
    np.testing.assert_array_equal(loaded.table.key_lo, dev_index.table.key_lo)
    np.testing.assert_array_equal(loaded.table.key_hi, dev_index.table.key_hi)
    assert loaded.table.max_probe == dev_index.table.max_probe
    np.testing.assert_array_equal(loaded.entry_slot, dev_index.entry_slot)
    assert loaded.max_node_id == dev_index.max_node_id


def test_load_index_reference_form(tmp_path):
    index = ki.build_toy_index(n_unique=300, k=31, n_nodes=100, seed=8)
    path = tmp_path / "index.npz"
    ki.save_reference_npz(path, index)
    dev_index = ki.load_index(path)
    assert dev_index.n_unique == len(np.unique(index.kmers))
    assert dev_index.max_node_id == index.max_node_id()


def test_load_index_counter_form(tmp_path):
    keys = np.unique(np.random.default_rng(9).integers(0, 1 << 62, 100, dtype=np.uint64))
    path = tmp_path / "counter.npz"
    np.savez(path, counter_keys=keys)
    dev_index = ki.load_index(path)
    assert dev_index.n_unique == len(keys)
    slots = layout.query_table(dev_index.table, keys)
    slot_counts = np.bincount(slots, minlength=dev_index.table.n_slots).astype(np.uint32)
    got_kmers, got_counts = dev_index.kmer_counts(slot_counts)
    order = np.argsort(got_kmers)
    np.testing.assert_array_equal(np.sort(got_kmers), np.sort(keys))
    np.testing.assert_array_equal(got_counts[order], 1)


def test_load_bundle(tmp_path):
    index = ki.build_toy_index(n_unique=200, k=31, n_nodes=64, seed=10)
    inner = io.BytesIO()
    np.savez(
        inner,
        hashes_to_index=index.hashes_to_index,
        n_kmers=index.n_kmers,
        kmers=index.kmers,
        nodes=index.nodes,
        frequencies=index.frequencies,
        modulo=np.uint64(index.modulo),
    )
    bundle = tmp_path / "bundle.zip"
    with zipfile.ZipFile(bundle, "w") as zf:
        zf.writestr("kmer_index.npz", inner.getvalue())
    dev_index = ki.load_index(bundle)
    assert dev_index.max_node_id == index.max_node_id()


def test_index_get_nodes():
    kmers = np.array([5, 9, 5], dtype=np.uint64)
    nodes = np.array([10, 11, 12], dtype=np.int32)
    arrays = oracle.build_kmer_index(kmers, nodes, 101)
    dev_index = ki.TpuKmerIndex.from_arrays(arrays)
    np.testing.assert_array_equal(np.sort(dev_index.get(5)), [10, 12])
    np.testing.assert_array_equal(dev_index.get(9), [11])
    assert len(dev_index.get(12345)) == 0


def test_empty_index():
    dev_index = ki.TpuKmerIndex.from_counter_keys(np.zeros(0, dtype=np.uint64))
    slots = layout.query_table(dev_index.table, np.array([1, 2, 3], dtype=np.uint64))
    np.testing.assert_array_equal(slots, -1)
    counts = dev_index.node_counts(np.zeros(dev_index.table.n_slots, np.uint32))
    assert counts.shape == (1,)


def test_sentinel_like_keys_are_valid():
    """lo == 0xFFFFFFFF with hi == 0 is a legal kmer (k <= 16) and must not be
    confused with the empty sentinel (0xFFFFFFFF, 0xFFFFFFFF)."""
    keys = np.array([0xFFFFFFFF, 0xFFFF, 1], dtype=np.uint64)
    table = layout.build_table(keys)
    slots = layout.query_table(table, keys)
    assert (slots >= 0).all()
    assert len(np.unique(slots)) == 3


def test_max_uint64_key_buildable():
    """The EMPTY sentinel is the all-ones MIXED pattern; since the key mix is
    a seeded bijection, any raw key (including all-ones) is representable —
    a sentinel collision just reseeds the build."""
    keys = np.array([1, 0xFFFFFFFFFFFFFFFF], dtype=np.uint64)
    table = layout.build_table(keys)
    assert (layout.query_table(table, keys) >= 0).all()


def test_adversarial_real_writer_npz(tmp_path):
    """A file byte-for-byte in the real graph_kmer_index writer's conventions:
    leading-underscore fields, `_ref_offsets` present, int64 `_nodes`, 0-d
    `_modulo`, uint32 frequencies (``kmer_mapper/util.py:38-68`` tolerances)."""
    index = ki.build_toy_index(n_unique=300, k=31, n_nodes=100, seed=9)
    path = tmp_path / "kmer_index_only_variants_with_revcomp.npz"
    np.savez(
        path,
        _hashes_to_index=index.hashes_to_index.astype(np.int64),
        _n_kmers=index.n_kmers.astype(np.int64),
        _kmers=index.kmers,
        _nodes=index.nodes.astype(np.int64),  # convert_to_int32() target
        _frequencies=index.frequencies.astype(np.uint32),
        _modulo=np.array(index.modulo, dtype=np.uint64),  # 0-d scalar
        _ref_offsets=np.arange(len(index.kmers), dtype=np.uint64),
    )
    loaded = ki.load_reference_npz(path)
    assert loaded.nodes.dtype == np.int32
    assert loaded.modulo == index.modulo
    np.testing.assert_array_equal(loaded.kmers, index.kmers)
    # end-to-end: counts through the device layout match the oracle probe
    dev_index = ki.load_index(str(path))
    queries = np.concatenate([index.kmers[:80], np.array([5, 6], dtype=np.uint64)])
    slot_counts = np.zeros(dev_index.table.n_slots, dtype=np.uint32)
    slots = layout.query_table(dev_index.table, queries)
    np.add.at(slot_counts, slots[slots >= 0], 1)
    got = dev_index.node_counts(slot_counts)
    want = oracle.map_kmers_to_index(
        index, queries, max_node_id=int(index.nodes.max())
    )
    np.testing.assert_array_equal(got[: len(want)], want)


def test_minimal_index_field_subset(tmp_path):
    """MinimalKmerIndex form: no frequencies AND no n_kmers (the loader must
    derive bucket lengths from consecutive start offsets); 'minimal' filename
    convention per ``util.py:56-58``."""
    index = ki.build_toy_index(n_unique=120, k=21, n_nodes=40, seed=10)
    path = tmp_path / "minimal_kmer_index.npz"
    np.savez(
        path,
        _hashes_to_index=index.hashes_to_index,
        _kmers=index.kmers,
        _nodes=index.nodes,
        _modulo=np.uint64(index.modulo),
    )
    loaded = ki.load_reference_npz(path)
    np.testing.assert_array_equal(loaded.frequencies, 1)
    assert (loaded.n_kmers >= 0).all()
    # derived bucket lengths must reproduce the original bucket structure
    np.testing.assert_array_equal(loaded.n_kmers, index.n_kmers)
    dev_index = ki.load_index(str(path))
    assert dev_index.n_unique == len(np.unique(index.kmers))


def test_sentinel_colliding_key_reseeds_and_stays_queryable():
    """A key whose MIXED words equal the EMPTY sentinel (crafted via the
    Feistel inverse) must trigger a reseeded rebuild, not silent loss."""
    from kmer_mapper_tpu.ops.u32hash import feistel_unmix, join_u64

    lo, hi = feistel_unmix(
        np.array([0xFFFFFFFF], np.uint32), np.array([0xFFFFFFFF], np.uint32), seed=0
    )
    evil = join_u64(lo, hi)[0]
    keys = np.array([evil, 5, 9, 1 << 40], dtype=np.uint64)
    table = layout.build_table(keys)
    assert table.seed != 0  # the build had to walk away from seed 0
    slots = layout.query_table(table, keys)
    assert (slots >= 0).all() and len(np.unique(slots)) == len(keys)
    # and the device probe counts it exactly
    import jax.numpy as jnp

    from kmer_mapper_tpu.ops import probe
    from kmer_mapper_tpu.ops.u32hash import split_u64

    qlo, qhi = split_u64(np.array([evil, evil, 5, 777], dtype=np.uint64))
    bucket, mask = probe.probe_hits(
        jnp.asarray(table.key_lo), jnp.asarray(table.key_hi),
        jnp.asarray(qlo), jnp.asarray(qhi), table.max_probe, table.seed,
    )
    out = np.asarray(probe.accumulate_scatter(
        jnp.zeros(table.n_slots, jnp.uint32), bucket, mask, jnp.ones(4, bool)
    ))
    assert out[slots[0]] == 2 and out.sum() == 3


def test_tpuidx_rejects_out_of_range_max_probe(tmp_path):
    """A .tpuidx whose table_max_probe exceeds layout.MAX_PROBE_HARD is a
    corrupt/foreign file: loading must fail loudly instead of unrolling an
    absurd number of probe rounds."""
    rng = np.random.default_rng(11)
    keys = np.unique(rng.integers(0, 1 << 62, 500, dtype=np.uint64))
    nodes = rng.integers(0, 50, len(keys)).astype(np.int32)
    dev_index = ki.TpuKmerIndex.from_entries(keys, nodes)
    path = tmp_path / "i.tpuidx.npz"
    dev_index.to_file(path)
    with np.load(path) as data:
        fields = {k: data[k] for k in data.files}
    fields["table_max_probe"] = np.int64(layout.MAX_PROBE_HARD + 1)
    bad = tmp_path / "bad.tpuidx.npz"  # np.savez appends .npz itself
    np.savez(bad, **fields)
    with pytest.raises(ValueError, match="table_max_probe"):
        ki.TpuKmerIndex.from_file(bad)

    # deep-but-plausible max_probe loads fine and the gather probe runs
    # every round: counts stay exact
    fields["table_max_probe"] = np.int64(9)
    deep = tmp_path / "deep.tpuidx.npz"
    np.savez(deep, **fields)
    idx = ki.TpuKmerIndex.from_file(deep)
    assert idx.table.max_probe == 9
    from kmer_mapper_tpu.models.mapper import KmerMapper, MapperConfig

    queries = np.concatenate([keys, keys[:7], np.arange(5, dtype=np.uint64)])
    mapper = KmerMapper(idx, MapperConfig(k=31, buf=256, max_reads=16))
    mapper.map_hashes(queries)
    slots = layout.query_table(idx.table, queries)
    np.testing.assert_array_equal(
        mapper.slot_counts(),
        np.bincount(slots[slots >= 0], minlength=idx.table.n_slots),
    )
    assert int(mapper.slot_counts().sum()) == len(keys) + 7


def _try_build_reference(keys, n_buckets, seed, max_probe_limit=layout.MAX_PROBE_LIMIT):
    """The pre-optimization formulation of layout._try_build (uniform
    per-round bisection + np.add.at) — kept here as the bit-identity oracle
    for the vectorized first-round fast path."""
    from kmer_mapper_tpu.ops.u32hash import bucket_from_mlo, feistel_mix, split_u64

    n = len(keys)
    lo, hi = feistel_mix(*split_u64(keys), seed=seed)
    if n and np.any((lo == layout.EMPTY) & (hi == layout.EMPTY)):
        return "sentinel"
    b = bucket_from_mlo(lo, n_buckets).astype(np.int64)
    key_lo = np.full((n_buckets, layout.BUCKET_KEYS), layout.EMPTY, dtype=np.uint32)
    key_hi = np.full((n_buckets, layout.BUCKET_KEYS), layout.EMPTY, dtype=np.uint32)
    filled = np.zeros(n_buckets, dtype=np.int64)
    slots = np.empty(n, dtype=np.int64)
    pending = np.arange(n, dtype=np.int64)
    probe = 0
    while len(pending):
        if probe >= max_probe_limit:
            return None
        order = np.argsort(b[pending], kind="stable")
        p = pending[order]
        sb = b[p]
        first = np.searchsorted(sb, sb, side="left")
        rank = np.arange(len(p), dtype=np.int64) - first
        avail = layout.BUCKET_KEYS - filled[sb]
        place = rank < avail
        pb, pr = sb[place], (filled[sb] + rank)[place]
        key_lo[pb, pr] = lo[p[place]]
        key_hi[pb, pr] = hi[p[place]]
        slots[p[place]] = pb * layout.BUCKET_KEYS + pr
        np.add.at(filled, pb, 1)
        pending = p[~place]
        if len(pending):
            b[pending] = layout.chain_next(b[pending], 1, n_buckets)
            probe += 1
    return layout.TableArrays(
        key_lo=key_lo, key_hi=key_hi, n_buckets=n_buckets, max_probe=probe + 1,
        seed=seed, build_slots=slots,
    )


@pytest.mark.parametrize(
    "n,n_buckets",
    [
        (5000, None),  # default load, spill rare
        (4096, 512),   # ~100% load: deep chains, multi-round general branch
        (300, 4),      # smaller than one chain block: whole-table wrap
        (0, 8),        # empty
        (1, 4),
    ],
)
def test_try_build_fast_path_bit_identical(n, n_buckets):
    """The round-1 fast path (int32 radix sort + run ranks + per-run filled
    update) assigns every slot identically to the reference formulation."""
    rng = np.random.default_rng(n + 7)
    keys = np.unique(rng.integers(0, 1 << 62, n, dtype=np.uint64)) if n else (
        np.zeros(0, dtype=np.uint64)
    )
    if n_buckets is None:
        n_buckets = layout._next_pow2(
            int(np.ceil(len(keys) / (layout.BUCKET_KEYS * layout.DEFAULT_MAX_LOAD)) or 1)
        )
    for limit in (layout.MAX_PROBE_LIMIT, 2, 1):
        got = layout._try_build(keys, n_buckets, seed=0, max_probe_limit=limit)
        want = _try_build_reference(keys, n_buckets, seed=0, max_probe_limit=limit)
        if want is None or want == "sentinel":
            assert got == want
            continue
        np.testing.assert_array_equal(got.key_lo, want.key_lo)
        np.testing.assert_array_equal(got.key_hi, want.key_hi)
        np.testing.assert_array_equal(got.build_slots, want.build_slots)
        assert got.max_probe == want.max_probe
        assert got.n_buckets == want.n_buckets

"""The reference's module paths work after a pure package rename:
``kmer_mapper.X`` -> ``kmer_mapper_tpu.X`` for mapper / gpu_counter / util /
command_line_interface (each maps the symbols its reference twin exports)."""
from __future__ import annotations

import types

import numpy as np

from kmer_mapper_tpu import oracle
from kmer_mapper_tpu.index import kmer_index as ki


def _toy(rng, n=300, n_nodes=40):
    keys = np.unique(rng.integers(0, 1 << 62, n, dtype=np.uint64))
    nodes = rng.integers(0, n_nodes, len(keys)).astype(np.int32)
    return keys, nodes, oracle.build_kmer_index(keys, nodes, 499)


def test_mapper_module_alias():
    from kmer_mapper_tpu.mapper import (
        in_graph_index,
        in_graph_index_no_memory_maps,
        map_kmers_to_graph_index,
    )

    rng = np.random.default_rng(1)
    keys, nodes, arrays = _toy(rng)
    got = map_kmers_to_graph_index(arrays, int(nodes.max()), keys[:50])
    want = oracle.map_kmers_to_index(arrays, keys[:50], max_node_id=int(nodes.max()))
    np.testing.assert_array_equal(got, want)
    member = in_graph_index(arrays, np.concatenate([keys[:5], np.array([2], np.uint64)]))
    assert member.tolist() == [1, 1, 1, 1, 1, 0] or member[:5].all()
    assert in_graph_index_no_memory_maps is in_graph_index


def test_gpu_counter_module_alias():
    from kmer_mapper_tpu.gpu_counter import GpuCounter

    rng = np.random.default_rng(2)
    keys, nodes, _ = _toy(rng)
    counter = GpuCounter.from_kmers_and_nodes(keys, nodes, 31)
    counter.initialize_cuda(0)
    counter.count(keys[:20])
    got = counter.get_node_counts()
    want = np.zeros(int(nodes.max()) + 1, dtype=np.uint32)
    np.add.at(want, nodes[:20], 1)
    np.testing.assert_array_equal(got, want)


def test_util_module_alias(tmp_path):
    from kmer_mapper_tpu import util

    # hashing glue parity
    hashes = util.get_kmer_hashes_from_chunk_sequence(["ACGTACG", "TTTTT"], 5)
    codes = oracle.encode_string("ACGTACGTTTTT")
    want = oracle.kmer_hashes_ragged(codes, np.array([7, 5]), 5)
    np.testing.assert_array_equal(hashes, want)
    # index resolution via args namespace (reference _get_kmer_index_from_args)
    rng = np.random.default_rng(3)
    _, _, arrays = _toy(rng)
    from kmer_mapper_tpu.index.kmer_index import save_reference_npz

    path = tmp_path / "i.npz"
    save_reference_npz(path, arrays)
    args = types.SimpleNamespace(kmer_index=str(path), index_bundle=None)
    index = util._get_kmer_index_from_args(args)
    assert index.n_unique == len(np.unique(arrays.kmers))
    # open_file yields the raw bytes
    f = tmp_path / "r.fa"
    f.write_text(">a\nACGT\n")
    stream = util.open_file(str(f))
    assert stream.read(100).startswith(b">a")
    stream.close()


def test_cli_module_alias(tmp_path):
    from kmer_mapper_tpu.command_line_interface import main, map_bnp, run_argument_parser

    assert callable(main) and callable(run_argument_parser)
    rng = np.random.default_rng(4)
    reads = ["".join(rng.choice(list("ACGT"), 40)) for _ in range(30)]
    codes = [oracle.encode_string(r) for r in reads]
    kmers = oracle.kmer_hashes_ragged(
        np.concatenate(codes), np.array([len(c) for c in codes]), 7
    )
    entries = np.unique(rng.choice(kmers, 200))
    nodes = rng.integers(0, 30, len(entries)).astype(np.int32)
    arrays = oracle.build_kmer_index(entries, nodes, 499)
    reads_path = tmp_path / "r.fa"
    reads_path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    args = types.SimpleNamespace(
        kmer_index=ki.TpuKmerIndex.from_arrays(arrays),  # in-memory index form
        reads=str(reads_path),
        kmer_size=7,
        output_file=None,
    )
    got = map_bnp(args)
    want = oracle.map_kmers_to_index(arrays, kmers, max_node_id=int(nodes.max()))
    np.testing.assert_array_equal(got, want)


def test_map_bnp_resolves_index_bundle(tmp_path):
    """A reference-parity caller passing only ``-b``/``args.index_bundle``
    (reference ``util.py:51-53``) must get the bundle's kmer_index."""
    import io as _io
    import zipfile

    from kmer_mapper_tpu.command_line_interface import map_bnp
    from kmer_mapper_tpu.index.kmer_index import save_reference_npz

    rng = np.random.default_rng(5)
    reads = ["".join(rng.choice(list("ACGT"), 40)) for _ in range(30)]
    codes = [oracle.encode_string(r) for r in reads]
    kmers = oracle.kmer_hashes_ragged(
        np.concatenate(codes), np.array([len(c) for c in codes]), 7
    )
    entries = np.unique(rng.choice(kmers, 200))
    nodes = rng.integers(0, 30, len(entries)).astype(np.int32)
    arrays = oracle.build_kmer_index(entries, nodes, 499)
    buf = _io.BytesIO()
    save_reference_npz(buf, arrays)
    bundle = tmp_path / "bundle.zip"
    with zipfile.ZipFile(bundle, "w") as zf:
        zf.writestr("kmer_index.npz", buf.getvalue())
    reads_path = tmp_path / "r.fa"
    reads_path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    args = types.SimpleNamespace(
        kmer_index=None,
        index_bundle=str(bundle),
        reads=str(reads_path),
        kmer_size=7,
        output_file=None,
    )
    got = map_bnp(args)
    want = oracle.map_kmers_to_index(arrays, kmers, max_node_id=int(nodes.max()))
    np.testing.assert_array_equal(got, want)


def test_map_cpu_worker_parity():
    """`map_cpu(args_dict, index, chunk)` returns the per-chunk partial node
    counts (reference command_line_interface.py:32-56; the chunk is passed
    directly instead of by shm name), N's counting as A."""
    import types

    from kmer_mapper_tpu.command_line_interface import map_cpu
    from kmer_mapper_tpu.index.kmer_index import TpuKmerIndex

    rng = np.random.default_rng(11)
    reads = ["".join(rng.choice(list("ACGT"), 35)) for _ in range(40)]
    reads[3] = reads[3][:5] + "N" + reads[3][6:]
    k = 7
    subst = [r.replace("N", "A") for r in reads]
    codes = [oracle.encode_string(r) for r in subst]
    kmers = oracle.kmer_hashes_ragged(
        np.concatenate(codes), np.array([len(c) for c in codes]), k
    )
    entries = np.unique(rng.choice(kmers, 150))
    nodes = rng.integers(0, 40, len(entries)).astype(np.int32)
    arrays = oracle.build_kmer_index(entries, nodes, 499)
    want = oracle.map_kmers_to_index(arrays, kmers)

    index = TpuKmerIndex.from_arrays(arrays)
    # dict args (the reference's worker shape) and namespace args both work
    got = map_cpu({"kmer_size": k}, index, reads)
    np.testing.assert_array_equal(got, want)
    got2 = map_cpu(types.SimpleNamespace(kmer_size=k), index, reads)
    np.testing.assert_array_equal(got2, want)


def test_map_gpu_loop_parity():
    """`map_gpu(index, chunks, k, ...)` counts every chunk (objects with a
    .sequence or plain lists), optionally with reverse complements, and
    returns node counts (reference command_line_interface.py:59-79)."""
    import types

    from kmer_mapper_tpu.command_line_interface import map_gpu
    from kmer_mapper_tpu.index.kmer_index import TpuKmerIndex

    rng = np.random.default_rng(12)
    k = 9
    reads = ["".join(rng.choice(list("ACGT"), 50)) for _ in range(60)]
    codes = [oracle.encode_string(r) for r in reads]
    kmers = oracle.kmer_hashes_ragged(
        np.concatenate(codes), np.array([len(c) for c in codes]), k
    )
    entries = np.unique(rng.choice(kmers, 200))
    nodes = rng.integers(0, 50, len(entries)).astype(np.int32)
    arrays = oracle.build_kmer_index(entries, nodes, 997)
    index = TpuKmerIndex.from_arrays(arrays)

    chunks = [
        types.SimpleNamespace(sequence=reads[:30]),  # reference chunk shape
        reads[30:],  # plain list also accepted
    ]
    got = map_gpu(index, iter(chunks), k)
    # GPU factorization (count uniques, distribute to entries) equals the
    # probe semantics here (tiny frequencies keep the filter inert)
    want = oracle.map_kmers_to_index(arrays, kmers)
    np.testing.assert_array_equal(got, want)

    q_rc = np.concatenate([kmers, oracle.revcomp_hash(kmers, k)])
    got_rc = map_gpu(
        index, iter(chunks), k, map_reverse_complements=True
    )
    want_rc = oracle.map_kmers_to_index(arrays, q_rc)
    np.testing.assert_array_equal(got_rc, want_rc)


def test_kmer_mapper_drop_in_package():
    """The literal ``kmer_mapper`` package (VERDICT r3 next-step #2): KAGE's
    exact imports work with ZERO edits — no package rename needed."""
    import kmer_mapper
    from kmer_mapper.command_line_interface import main, map_bnp, run_argument_parser
    from kmer_mapper.encodings import ACTGTwoBitEncoding, twobit_swap
    from kmer_mapper.gpu_counter import GpuCounter
    from kmer_mapper.mapper import in_graph_index, map_kmers_to_graph_index
    from kmer_mapper.util import (
        _get_kmer_index_from_args,
        get_kmer_hashes_from_chunk_sequence,
        open_file,
    )

    assert kmer_mapper.IS_TPU_DROP_IN
    assert callable(main) and callable(run_argument_parser) and callable(map_bnp)
    assert callable(open_file) and callable(_get_kmer_index_from_args)
    assert callable(GpuCounter.from_kmers_and_nodes)
    assert callable(twobit_swap) and hasattr(ACTGTwoBitEncoding, "from_string")

    # the re-exports are the SAME objects as the kmer_mapper_tpu bodies
    import kmer_mapper_tpu.mapper as pkg_mapper

    assert map_kmers_to_graph_index is pkg_mapper.map_kmers_to_graph_index
    assert in_graph_index is pkg_mapper.in_graph_index

    # KAGE's per-batch call works through the drop-in path end to end
    rng = np.random.default_rng(7)
    keys, nodes, arrays = _toy(rng)
    got = map_kmers_to_graph_index(arrays, int(nodes.max()), keys[:40])
    want = oracle.map_kmers_to_index(arrays, keys[:40], max_node_id=int(nodes.max()))
    np.testing.assert_array_equal(got, want)
    hashes = get_kmer_hashes_from_chunk_sequence(["ACGTACG"], 5)
    np.testing.assert_array_equal(
        hashes,
        oracle.kmer_hashes_ragged(oracle.encode_string("ACGTACG"), np.array([7]), 5),
    )


def test_kmer_mapper_console_script_declared():
    """pyproject ships the ``kmer_mapper`` console script pointing at the
    drop-in main (reference setup.py:31-33)."""
    import pathlib
    import kmer_mapper

    root = pathlib.Path(kmer_mapper.__file__).resolve().parents[1]
    text = (root / "pyproject.toml").read_text()
    assert 'kmer_mapper = "kmer_mapper.command_line_interface:main"' in text
    assert '"kmer_mapper*"' in text  # packaged into the wheel

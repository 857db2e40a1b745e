"""Headline scale validation: map 10M x 151 bp reads (1.21 Gkmers) at k=31
against a 16M-unique-kmer index, end-to-end through the file pipeline on one
device. Reports wall-clock after the one-time compile (first chunk) and
verifies a sampled subset of counts against the numpy oracle. The reads file
is kept in the temporary directory between runs."""
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N_READS = 10_000_000
READ_LEN = 151
K = 31


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    import tempfile

    from kmer_mapper_tpu import oracle, pipeline
    from kmer_mapper_tpu.index import kmer_index as ki
    from kmer_mapper_tpu.io import native
    from kmer_mapper_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    tmp = Path(tempfile.gettempdir()) / "kmt_scale"
    tmp.mkdir(exist_ok=True)
    reads_path = tmp / "reads10m.fa"
    rng = np.random.default_rng(0)

    if not reads_path.exists():
        t = time.perf_counter()
        with open(reads_path, "wb") as f:
            chunk_reads = 100_000
            for c in range(N_READS // chunk_reads):
                seqs = rng.choice(np.frombuffer(b"ACGT", np.uint8), (chunk_reads, READ_LEN))
                parts = [
                    b">r%d\n" % (c * chunk_reads + i) + seqs[i].tobytes() + b"\n"
                    for i in range(chunk_reads)
                ]
                f.write(b"".join(parts))
        log(f"wrote {reads_path.stat().st_size / 1e9:.2f} GB in {time.perf_counter() - t:.0f}s")

    # index: sampled from the reads + random keys (fresh generator: index
    # contents must not depend on whether the reads file already existed)
    rng = np.random.default_rng(1)
    t = time.perf_counter()
    with open(reads_path, "rb") as f:
        head = f.read(4 << 20)
    sample_bases = np.frombuffer(
        b"".join(l for l in head.split(b"\n") if l and not l.startswith(b">")), np.uint8
    )
    read_kmers = oracle.kmer_hashes(oracle.encode_bytes(sample_bases[: 2 << 20]), K)
    entry = np.unique(
        np.concatenate(
            [
                rng.integers(0, 1 << 62, 8_000_000, dtype=np.uint64),
                rng.choice(read_kmers, 8_000_000),
            ]
        )
    )
    nodes = rng.integers(0, 10_000_000, len(entry)).astype(np.int32)
    index = ki.TpuKmerIndex.from_entries(entry, nodes)
    log(
        f"index: {index.n_unique / 1e6:.1f}M unique, table {index.table.nbytes / 1e9:.2f} GB, "
        f"built in {time.perf_counter() - t:.0f}s; native loader: {native.available()}"
    )

    t0 = time.perf_counter()
    counts = pipeline.map_file(index, str(reads_path), k=K, chunk_size=4 << 20)
    wall = time.perf_counter() - t0
    n_kmers = N_READS * (READ_LEN - K + 1)
    log(
        f"TOTAL: {wall:.1f}s wall (incl. one-time compile) for {n_kmers / 1e9:.2f} Gkmers "
        f"= {n_kmers / wall / 1e6:.0f} Mkmers/s; counts sum {counts.sum()}"
    )
    # second pass reuses the in-process jit cache: steady-state wall clock
    # (host frame + transfer + device map, no compiles)
    t0 = time.perf_counter()
    counts2 = pipeline.map_file(index, str(reads_path), k=K, chunk_size=4 << 20,
                                progress=False)
    steady = time.perf_counter() - t0
    assert counts2.sum() == counts.sum()
    log(
        f"STEADY: {steady:.1f}s wall for {n_kmers / 1e9:.2f} Gkmers "
        f"= {n_kmers / steady / 1e6:.0f} Mkmers/s end-to-end"
    )

    # exact verification: first chunk of records vs the numpy oracle
    from kmer_mapper_tpu.index import layout
    from kmer_mapper_tpu.io import readers

    chunk = next(readers.read_chunks(str(reads_path), min_chunk_size=1 << 20))
    prefix = tmp / "head.fa"
    with open(prefix, "w") as g:
        ends = np.append(chunk.read_starts[1:], chunk.n_bases)
        for i, (s, e) in enumerate(zip(chunk.read_starts, ends)):
            g.write(f">r{i}\n{bytes(chunk.bases[s:e]).decode()}\n")
    got = pipeline.map_file(index, str(prefix), k=K, chunk_size=1 << 20, progress=False)
    pref_kmers = oracle.kmer_hashes_ragged(
        oracle.encode_bytes(chunk.bases), chunk.read_lengths, K
    )
    slots = layout.query_table(index.table, pref_kmers)
    slot_counts = np.bincount(slots[slots >= 0], minlength=index.table.n_slots)
    expect = index.node_counts(slot_counts)
    np.testing.assert_array_equal(got, expect)
    log(f"prefix verification OK ({len(pref_kmers)} kmers, sum {got.sum()})")
    print(f"{wall:.1f}s for {n_kmers} kmers; sum={int(counts.sum())}")


if __name__ == "__main__":
    main()

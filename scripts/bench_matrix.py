"""BASELINE.json config matrix: measured numbers for BASELINE.md.

Covers the five benchmark configurations on whatever accelerator JAX provides:
  1. toy .fa against a toy .npz index, single chunk (correctness + latency)
  2. gzipped FASTQ streaming (host decode + device map)
  3. k sweep (16/21/31) with reverse complements and N-masking
  4. large device-resident index, higher read volume
  5. index sharded over available devices (all-reduce of counts)

Each config reports wall time, mapped kmers/s, and the node-count sum (> 0:
indexes are built from the reads' own kmers). First run per config includes
compilation; heavier than bench.py — run manually.
"""
import gzip
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def make_reads(rng, n_reads, read_len=151, with_n=False):
    alphabet = list("ACGTN") if with_n else list("ACGT")
    p = [0.24, 0.24, 0.24, 0.24, 0.04] if with_n else None
    return ["".join(rng.choice(alphabet, read_len, p=p)) for _ in range(n_reads)]


def write_reads(path, reads, gz=False, fastq=False):
    if fastq:
        data = "".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(reads))
    else:
        data = "".join(f">r{i}\n{s}\n" for i, s in enumerate(reads))
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(data)
    else:
        Path(path).write_text(data)
    return str(path)


def index_from_reads(rng, reads, k, n_extra, n_nodes, sample=30_000):
    from kmer_mapper_tpu import oracle
    from kmer_mapper_tpu.index import kmer_index as ki

    codes = oracle.encode_bytes(
        np.frombuffer("".join(reads[:200]).replace("N", "A").encode(), np.uint8)
    )
    read_kmers = oracle.kmer_hashes(codes, k)
    entry = np.unique(
        np.concatenate(
            [
                rng.choice(read_kmers, min(sample, len(read_kmers))),
                rng.integers(0, 1 << 62, n_extra, dtype=np.uint64)
                & np.uint64(4**k - 1 if k < 32 else -1),
            ]
        )
    )
    nodes = rng.integers(0, n_nodes, len(entry)).astype(np.int32)
    return ki.TpuKmerIndex.from_entries(entry, nodes)


def main():
    import tempfile

    import jax

    from kmer_mapper_tpu import pipeline
    from kmer_mapper_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    tmp = Path(tempfile.mkdtemp(prefix="kmt_bench_"))
    rng = np.random.default_rng(0)
    rows = []

    def run(name, n_kmers, fn):
        t = time.perf_counter()
        fn()  # warm-up: compile (cached across runs where possible)
        warm = time.perf_counter() - t
        t = time.perf_counter()
        out = fn()
        dt = time.perf_counter() - t
        rate = n_kmers / dt / 1e6
        rows.append((name, dt, rate, int(out.sum())))
        log(f"{name}: warm {warm:.1f}s, steady {dt:.2f}s = {rate:.1f} Mkmers/s, sum={int(out.sum())}")

    # config 1: toy single chunk
    reads1 = make_reads(rng, 2000)
    idx1 = index_from_reads(rng, reads1, 31, 2000, 500)
    p1 = write_reads(tmp / "toy.fa", reads1)
    nk1 = 2000 * (151 - 30)
    run("1 toy fa single chunk", nk1, lambda: pipeline.map_file(idx1, p1, k=31))

    # config 2: gzipped FASTQ streaming, 4M-unique index
    reads2 = make_reads(rng, 100_000)
    idx2 = index_from_reads(rng, reads2, 31, 4_000_000, 3_000_000)
    log(f"config-2 index: {idx2.n_unique} unique, {idx2.table.nbytes / 1e6:.0f} MB")
    p2 = write_reads(tmp / "big.fq.gz", reads2, gz=True, fastq=True)
    nk2 = 100_000 * (151 - 30)
    run("2 gz fastq streaming", nk2, lambda: pipeline.map_file(idx2, p2, k=31))

    # config 3: k sweep with revcomp + N reads
    reads3 = make_reads(rng, 50_000, with_n=True)
    p3 = write_reads(tmp / "n.fa", reads3)
    for k in (16, 21, 31):
        idx3 = index_from_reads(rng, [r.replace("N", "A") for r in reads3], k, 500_000, 100_000)
        nk3 = 2 * 50_000 * (151 - k + 1)  # fwd + revcomp
        run(
            f"3 k={k} revcomp+N",
            nk3,
            lambda idx3=idx3, k=k: pipeline.map_file(
                idx3, p3, k=k, map_reverse_complements=True
            ),
        )

    # config 4: large device-resident index, higher volume
    reads4 = make_reads(rng, 300_000)
    idx4 = index_from_reads(rng, reads4, 31, 16_000_000, 3_000_000, sample=100_000)
    log(f"config-4 index: {idx4.n_unique} unique, {idx4.table.nbytes / 1e6:.0f} MB")
    p4 = write_reads(tmp / "vol.fa", reads4)
    nk4 = 300_000 * (151 - 30)
    run("4 large index volume", nk4, lambda: pipeline.map_file(idx4, p4, k=31))

    # config 5: sharded over available devices
    n_dev = len(jax.devices())
    if n_dev >= 2:
        run(
            f"5 sharded x{n_dev}",
            nk4,
            lambda: pipeline.map_file_sharded(
                idx4, p4, k=31, n_devices=n_dev, index_parallel=min(2, n_dev)
            ),
        )
    else:
        log("5 sharded: skipped (single device)")

    print("| config | steady wall (s) | Mkmers/s | node-count sum |")
    print("|---|---|---|---|")
    for name, dt, rate, total in rows:
        print(f"| {name} | {dt:.2f} | {rate:.1f} | {total} |")


if __name__ == "__main__":
    main()

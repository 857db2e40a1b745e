#!/usr/bin/env python3
"""On-card smoke run of the mapping path.

    python chip_smoke.py            # one GPU
    python chip_smoke.py --four     # four GPUs: sharded map_file vs one card

From ``--seed`` it builds an index of ``--n-kmers`` unique 31-mers (half of
them k-mers of the reads, so hits are real), writes ``--n-reads`` 150 bp
FASTQ reads, and maps them through the CLI entry point
(``cli.run_argument_parser(["map", ...])``). Every device path is integer
arithmetic, so every comparison with the numpy oracle (``oracle.py``) is
bit-exact. Phases on one GPU:

1. the FASTQ through the CLI: the k-mer count must equal the number of valid
   windows, and node counts of a deterministic subset (every
   ``--subset-stride``-th read, mapped through the same entry point) must
   equal the oracle's;
2. ``--n-ragged`` ragged-length reads as gzipped FASTA with ``-r`` (reverse
   complements), compared whole with the oracle;
3. the library surface, ``compat.map_kmers_to_graph_index``, on a pre-hashed
   batch of ``--n-hashes`` k-mers, compared with the oracle;
4. the card-only tests (``pytest -m gpu``), run in a child process before
   this process first touches JAX, so one process holds the card at a time.

It also times the two fixed-read-length step formulations (word-plane step
and read_len slice step) on the same device-resident chunks. With
``--four`` it runs only ``map_file_sharded`` on four GPUs with a replicated
table and with four bucket-range shards, each compared with a one-GPU
``map_file`` of the same file.

It refuses to run without a GPU. The times it prints are smoke numbers from
one run, not benchmark numbers. The last line of standard output is one JSON
object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""
from __future__ import annotations

import argparse
import gzip
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from kmer_mapper_tpu import oracle  # fails alone: the script needs the repo

REPO = Path(__file__).resolve().parent
K = 31
READ_LEN = 150
PRODUCTION_CHUNK = 2_500_000  # the CLI's default --chunk-size


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """``name, power.limit`` of each card, as nvidia-smi gives them."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        raise SystemExit("chip_smoke: nvidia-smi not found: no GPU on this machine")
    return subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def require_gpu(devices) -> None:
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "no device"
        raise SystemExit(f"chip_smoke: JAX found {found}, not a GPU")


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps(
        {"ok": True, "device": {"platform": d.platform, "kind": d.device_kind,
                                "count": len(devices)}}
    )


def run_card_tests(junit: Path) -> int:
    """Run the ``gpu``-marked tests in a child process; every one must pass
    (none skipped). Returns the number of tests run."""
    env = dict(os.environ, KMT_TESTS_ON_CARD="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-p", "no:cacheprovider",
         f"--junitxml={junit}", str(REPO / "tests")],
        cwd=REPO, env=env, capture_output=True, text=True,
    )
    say(proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else "(no output)")
    if proc.returncode != 0:
        raise SystemExit(f"card-only tests failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-2000:]}")
    suite = ET.parse(junit).getroot()
    suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
    n = {k: int(suite.get(k)) for k in ("tests", "failures", "errors", "skipped")}
    if n["tests"] == 0 or n["failures"] or n["errors"] or n["skipped"]:
        raise SystemExit(f"card-only tests did not all run and pass: {n}")
    return n["tests"]


# --- data made from the seed ---------------------------------------------------


def make_reads(rng, n_reads: int, read_len: int = READ_LEN) -> np.ndarray:
    """ASCII reads uint8[n_reads, read_len]: uniform ACGT with ~0.1% N."""
    bases = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, (n_reads, read_len), dtype=np.uint8)
    ]
    n_n = max(1, bases.size // 1000)
    bases.reshape(-1)[rng.integers(0, bases.size, n_n)] = ord("N")
    return bases


def window_hashes(bases: np.ndarray, rows: np.ndarray, starts: np.ndarray, k: int):
    """Hashes of the windows [starts, starts + k) of the given reads."""
    codes = oracle.CODE_TABLE[bases]  # N -> A, like the reference
    h = np.zeros(len(rows), np.uint64)
    for m in range(k):
        h |= codes[rows, starts + m].astype(np.uint64) << np.uint64(2 * m)
    return h


def make_index_entries(rng, bases: np.ndarray, n_unique: int, k: int = K):
    """(entry kmers, entry nodes) with ``n_unique`` distinct kmers: half are
    windows of ``bases``, half random; ~10% of kmers carry a second entry."""
    n_reads, L = bases.shape
    half = n_unique // 2 + n_unique // 16  # headroom for duplicate draws
    from_reads = window_hashes(
        bases, rng.integers(0, n_reads, half), rng.integers(0, L - k + 1, half), k
    )
    read_keys = np.unique(from_reads)
    read_keys = read_keys[rng.permutation(len(read_keys))[: n_unique // 2]]
    mask = np.uint64((1 << (2 * k)) - 1)
    random = np.setdiff1d(rng.integers(0, 1 << 62, half, dtype=np.uint64) & mask, read_keys)
    random = random[rng.permutation(len(random))[: n_unique - len(read_keys)]]
    unique = np.concatenate([read_keys, random])
    assert len(unique) == n_unique, "not enough distinct kmers drawn"
    kmers = np.concatenate([unique, rng.choice(unique, n_unique // 10)])
    nodes = rng.integers(0, max(1000, n_unique // 8), len(kmers)).astype(np.int32)
    return kmers, nodes


def write_fastq(path: Path, bases: np.ndarray, block: int = 1 << 17) -> None:
    """Fixed-length FASTQ records ``@r<9 digits>``, quality all 'I'."""
    n, L = bases.shape
    width = 12 + L + 3 + L + 1  # header, bases, "\n+\n", quality, "\n"
    pos10 = 10 ** np.arange(8, -1, -1, dtype=np.int64)
    with open(path, "wb") as f:
        for a in range(0, n, block):
            rows = bases[a : a + block]
            out = np.empty((len(rows), width), np.uint8)
            ids = np.arange(a, a + len(rows), dtype=np.int64)
            out[:, 0] = ord("@")
            out[:, 1] = ord("r")
            out[:, 2:11] = (ids[:, None] // pos10) % 10 + ord("0")
            out[:, 11] = ord("\n")
            out[:, 12 : 12 + L] = rows
            out[:, 12 + L : 15 + L] = np.frombuffer(b"\n+\n", np.uint8)
            out[:, 15 + L : 15 + 2 * L] = ord("I")
            out[:, -1] = ord("\n")
            f.write(out.tobytes())


def make_ragged(rng, bases: np.ndarray, n_reads: int) -> list[bytes]:
    """Ragged reads (10..150 bp) cut from ``bases``; half reverse-complemented,
    so both strands hit the index."""
    comp = np.zeros(256, np.uint8)
    comp[list(b"ACGTN")] = list(b"TGCAN")
    out = []
    rows = rng.integers(0, len(bases), n_reads)
    lens = rng.integers(10, bases.shape[1] + 1, n_reads)
    starts = rng.integers(0, bases.shape[1] - lens + 1)
    flip = rng.random(n_reads) < 0.5
    for r, s, n, f in zip(rows, starts, lens, flip):
        seq = bases[r, s : s + n]
        out.append((comp[seq[::-1]] if f else seq).tobytes())
    return out


def oracle_counts(arrays, reads: list[bytes], revcomp: bool = False) -> np.ndarray:
    codes = oracle.encode_bytes(np.frombuffer(b"".join(reads), np.uint8))
    hashes = oracle.kmer_hashes_ragged(codes, np.array([len(r) for r in reads]), K)
    if revcomp:
        hashes = np.concatenate([hashes, oracle.revcomp_hash(hashes, K)])
    return oracle.map_kmers_to_index(arrays, hashes)


# --- the CLI -----------------------------------------------------------------


class _MappedKmers(logging.Handler):
    """Reads the k-mer total from the pipeline's final "Mapped %d kmers" log."""

    def __init__(self):
        super().__init__()
        self.n_kmers = None

    def emit(self, record):
        if str(record.msg).startswith("Mapped "):
            self.n_kmers = int(record.args[0])


def run_cli(args: list[str]) -> tuple[np.ndarray, int, float]:
    """(node counts, k-mers mapped, wall seconds) of one ``map`` command
    (``args`` must include ``-o``)."""
    from kmer_mapper_tpu import cli

    out = Path(args[args.index("-o") + 1])
    handler = _MappedKmers()
    pipeline_log = logging.getLogger("kmer_mapper_tpu.pipeline")
    level = pipeline_log.level
    pipeline_log.setLevel(logging.INFO)
    pipeline_log.addHandler(handler)
    try:
        t = time.perf_counter()
        cli.run_argument_parser(["map", *args])
        wall = time.perf_counter() - t
    finally:
        pipeline_log.removeHandler(handler)
        pipeline_log.setLevel(level)
    if handler.n_kmers is None:
        raise SystemExit("the CLI logged no k-mer total")
    return np.load(out), handler.n_kmers, wall


def _map_args(index_path: str, reads: Path, chunk_size: int) -> list[str]:
    return ["-i", index_path, "-f", str(reads), "-k", str(K), "-c", str(chunk_size)]


def phase_fastq(workdir: Path, index_path: str, arrays, bases: np.ndarray,
                subset_stride: int, chunk_size: int = PRODUCTION_CHUNK) -> None:
    """Phase 1: fixed-length FASTQ through the CLI."""
    n_reads, L = bases.shape
    fq = workdir / "reads.fq"
    write_fastq(fq, bases)
    counts, n_kmers, wall = run_cli(
        [*_map_args(index_path, fq, chunk_size), "-o", str(workdir / "all.npy")]
    )
    want = n_reads * (L - K + 1)
    if n_kmers != want:
        raise SystemExit(f"phase 1: {n_kmers} k-mers mapped, {want} valid windows")
    if len(counts) != arrays.max_node_id() + 1 or not counts.any():
        raise SystemExit(f"phase 1: node counts of shape {counts.shape}, sum {counts.sum()}")
    say(f"phase 1: {n_reads} reads, {n_kmers} k-mers, map wall {wall:.2f} s "
        f"(CLI, compile included); node-count sum {int(counts.sum())}")

    subset = bases[::subset_stride]
    sub_fq = workdir / "subset.fq"
    write_fastq(sub_fq, subset)
    got, n_sub, wall = run_cli(
        [*_map_args(index_path, sub_fq, chunk_size), "-o", str(workdir / "sub.npy")]
    )
    expect = oracle_counts(arrays, [r.tobytes() for r in subset])
    if n_sub != len(subset) * (L - K + 1) or not np.array_equal(got, expect):
        raise SystemExit("phase 1: subset node counts differ from the oracle")
    say(f"phase 1: subset of {len(subset)} reads bit-exact vs oracle "
        f"(node-count sum {int(got.sum())}), map wall {wall:.2f} s")


def gzip_decoder(path: Path) -> str:
    from kmer_mapper_tpu.io import gzio

    stream = gzio.open_gzip(str(path))
    try:
        return f"{type(stream).__module__}.{type(stream).__name__}"
    finally:
        stream.close()


def phase_ragged(workdir: Path, index_path: str, arrays, reads: list[bytes],
                 chunk_size: int = PRODUCTION_CHUNK) -> None:
    """Phase 2: ragged gzipped FASTA with reverse complements."""
    fa = workdir / "ragged.fa.gz"
    with gzip.open(fa, "wb", compresslevel=1) as f:
        f.write(b"".join(b">q%d\n%s\n" % (i, r) for i, r in enumerate(reads)))
    got, n_kmers, wall = run_cli(
        [*_map_args(index_path, fa, chunk_size), "-r", "true",
         "-o", str(workdir / "ragged.npy")]
    )
    expect = oracle_counts(arrays, reads, revcomp=True)
    if not np.array_equal(got, expect):
        raise SystemExit("phase 2: ragged -r node counts differ from the oracle")
    say(f"phase 2: {len(reads)} ragged reads (gzip decoder {gzip_decoder(fa)}), "
        f"{n_kmers} k-mers (+ reverse complements) bit-exact vs oracle, "
        f"map wall {wall:.2f} s")


def phase_library(index, arrays, rng, n_hashes: int) -> None:
    """Phase 3: the pre-hashed library surface."""
    from kmer_mapper_tpu import compat

    present = rng.choice(arrays.kmers, n_hashes // 2)
    mask = np.uint64((1 << (2 * K)) - 1)
    kmers = np.concatenate([
        present, rng.integers(0, 1 << 62, n_hashes - len(present), dtype=np.uint64) & mask
    ])
    t = time.perf_counter()
    got = compat.map_kmers_to_graph_index(index, index.max_node_id, kmers, 1000)
    wall = time.perf_counter() - t
    if not np.array_equal(got, oracle.map_kmers_to_index(arrays, kmers)):
        raise SystemExit("phase 3: map_kmers_to_graph_index differs from the oracle")
    say(f"phase 3: map_kmers_to_graph_index on {n_hashes} hashes bit-exact vs "
        f"oracle, wall {wall:.2f} s (first call: table upload + compile)")


def time_plane_vs_slice(index, bases: np.ndarray, buf: int, max_chunks: int = 8,
                        reps: int = 5) -> None:
    """Device time of the word-plane step and the read_len slice step on the
    same resident chunks; both must leave identical counts."""
    import jax
    import jax.numpy as jnp

    from kmer_mapper_tpu.io import readers
    from kmer_mapper_tpu.models.mapper import KmerMapper, default_config

    L = bases.shape[1]
    config = default_config(k=K, buf=buf, max_reads=max(1024, buf // 32), read_len=L)
    mapper = KmerMapper(index, config)
    R = readers.strided_rows(buf, L)
    n_chunks = max(1, min(max_chunks, len(bases) // R))
    plane, sliced = [], []
    n_kmers = 0
    for c in range(n_chunks):
        rows = bases[c * R : (c + 1) * R]
        chunk = readers.SequenceChunk(
            bases=rows.reshape(-1), read_starts=np.arange(len(rows), dtype=np.int64) * L,
        )
        (p, _, _, nr, _, strided), = readers.pack_for_device(
            iter([chunk]), buf, config.max_reads, K, read_len=L
        )
        (pc, ln, nb, _, _), = readers.pack_for_device(iter([chunk]), buf, config.max_reads, K)
        assert strided
        n_kmers += nr * (L - K + 1)
        plane.append((jax.device_put(p), jnp.int32(nr)))
        sliced.append((jax.device_put(pc), jax.device_put(ln), jnp.int32(nb)))
    finals = {}
    for name, step, chunks in (("plane", mapper._plane_step, plane),
                               ("slice", mapper._step, sliced)):
        zeros = jnp.zeros(index.table.n_slots, jnp.uint32)
        t = time.perf_counter()
        run = step.lower(mapper.key_lo, mapper.key_hi, zeros, *chunks[0]).compile()
        compile_s = time.perf_counter() - t
        counts, _ = run(mapper.key_lo, mapper.key_hi, zeros, *chunks[0])
        counts.block_until_ready()
        counts = jnp.zeros(index.table.n_slots, jnp.uint32)
        t = time.perf_counter()
        for _ in range(reps):
            for args in chunks:
                counts, _ = run(mapper.key_lo, mapper.key_hi, counts, *args)
        counts.block_until_ready()
        per_step = (time.perf_counter() - t) / (reps * n_chunks)
        finals[name] = np.asarray(counts)
        rate = n_kmers / n_chunks / per_step
        say(f"step timing: {name} step, buffer {buf} bases, {n_chunks} chunks of "
            f"<= {R} reads: compile {compile_s:.2f} s, {per_step * 1e3:.3f} ms/step "
            f"= {rate / 1e6:.1f} Mk/s (host clock over {reps * n_chunks} queued steps)")
    if not np.array_equal(finals["plane"], finals["slice"]):
        raise SystemExit("plane step and slice step counts differ")


def phase_four(workdir: Path, index_path: str, bases: np.ndarray,
               n_devices: int = 4, chunk_size: int = PRODUCTION_CHUNK) -> None:
    """``map_file_sharded`` on ``n_devices`` GPUs, replicated table and
    bucket-range shards, each bit-exact against a one-GPU ``map_file``."""
    fq = workdir / "reads.fq"
    write_fastq(fq, bases)
    base = _map_args(index_path, fq, chunk_size)
    one, n_one, wall = run_cli([*base, "-o", str(workdir / "one.npy")])
    say(f"four: one-GPU map_file: {n_one} k-mers, map wall {wall:.2f} s")
    for index_parallel in (1, n_devices):
        got, n_kmers, wall = run_cli([
            *base, "--n-devices", str(n_devices), "--index-parallel",
            str(index_parallel), "-o", str(workdir / f"four{index_parallel}.npy"),
        ])
        if n_kmers != n_one or not np.array_equal(got, one):
            raise SystemExit(
                f"four: index_parallel={index_parallel} differs from one GPU"
            )
        say(f"four: {n_devices} GPUs, index_parallel={index_parallel}: bit-exact "
            f"vs one GPU, map wall {wall:.2f} s")


def build_index(kmers, nodes, workdir: Path):
    """(device index, path of the saved index)."""
    from kmer_mapper_tpu.index import kmer_index as ki

    t = time.perf_counter()
    index = ki.TpuKmerIndex.from_entries(kmers, nodes)
    build_s = time.perf_counter() - t
    path = workdir / "index.tpuidx.npz"
    index.to_file(path)
    say(f"index: {index.n_unique} unique {K}-mers, {len(kmers)} entries, "
        f"{index.table.n_buckets} buckets, table {index.table.nbytes / 1e9:.2f} GB, "
        f"max_probe {index.table.max_probe}; build {build_s:.1f} s")
    return index, str(path)


def oracle_index(kmers, nodes):
    """The reference-layout index the oracle probes."""
    return oracle.build_kmer_index(kmers, nodes, max(3, int(len(kmers) * 1.7) | 1))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded path and its comparison")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-kmers", type=int, default=1 << 25)
    ap.add_argument("--n-reads", type=int, default=1 << 20)
    ap.add_argument("--n-ragged", type=int, default=200_000)
    ap.add_argument("--n-hashes", type=int, default=(1 << 22) + 12_345)
    ap.add_argument("--subset-stride", type=int, default=20)
    args = ap.parse_args(argv)

    say(f"card: {card_line()}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        workdir = Path(tmp)
        if not args.four:
            n = run_card_tests(workdir / "card_tests.xml")
            say(f"phase 4: {n} card-only tests passed (child process)")

        import jax

        devices = jax.devices()
        require_gpu(devices)
        if args.four and len(devices) < 4:
            raise SystemExit(f"--four needs four GPUs; JAX found {len(devices)}")
        from kmer_mapper_tpu.io import native
        from kmer_mapper_tpu.pipeline import device_buffer
        from kmer_mapper_tpu.utils.compile_cache import enable_compile_cache

        say(f"jax {jax.__version__}; compile cache {enable_compile_cache()}; "
            f"framer {'native C++' if native.available() else 'numpy'}")
        rng = np.random.default_rng(args.seed)
        bases = make_reads(rng, args.n_reads)
        kmers, nodes = make_index_entries(rng, bases, args.n_kmers)
        index, index_path = build_index(kmers, nodes, workdir)
        if args.four:
            phase_four(workdir, index_path, bases)
        else:
            arrays = oracle_index(kmers, nodes)
            phase_fastq(workdir, index_path, arrays, bases, args.subset_stride)
            phase_ragged(workdir, index_path, arrays, make_ragged(rng, bases, args.n_ragged))
            phase_library(index, arrays, rng, args.n_hashes)
            for buf in (device_buffer(PRODUCTION_CHUNK), 64 << 20):
                time_plane_vs_slice(index, bases, buf)
        for d in devices:
            stats = d.memory_stats() or {}
            say(f"{d}: peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    say(result_line(devices))


if __name__ == "__main__":
    main()

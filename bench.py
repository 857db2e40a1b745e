"""Benchmark: k-mers hashed + looked-up per second on one GPU.

Runs the full device chunk step (hash -> gather probe -> count accumulate)
on synthetic 151 bp reads at k=31 against a synthetic 4M-unique-kmer index,
steady-state. Refuses to run without a GPU.

Methodology: the measured window is ONE jitted executable chaining STEPS
chunk steps over STEPS DISTINCT device-resident packed chunks (counts
donated, in-place). One dispatch + one scalar fetch per window keeps
dispatch latency out of the measurement; streaming-feed rates are logged to
stderr for reference. Every chunk in the window MUST be distinct: with
repeated chunks XLA CSE dedupes the pure hash subgraphs and the window only
pays them once per distinct chunk. The baseline is the reference CPU path's
semantics measured as the vectorized numpy oracle on this host, scaled to
the reference's default 16 worker threads (``command_line_interface.py:168``)
— the reference publishes no numbers of its own (BASELINE.md).

Prints exactly ONE JSON line to stdout; diagnostics go to stderr.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


# env-gated bench matrix: the default JSON line is the k=31 / 151 bp /
# fixed-length config; BENCH_K, BENCH_REVCOMP=1 and BENCH_RAGGED=1 select the
# other headline configs (reference: -k at command_line_interface.py:167,
# revcomp gpu_counter.py:23-24, ragged = mixed-length FASTA/FASTQ framing)
K = int(os.environ.get("BENCH_K", "31"))
READ_LEN = 151
RAGGED = os.environ.get("BENCH_RAGGED", "0") == "1"
REVCOMP = os.environ.get("BENCH_REVCOMP", "0") == "1"
BUF = int(os.environ.get("BENCH_BUF_MI", "64")) << 20
N_UNIQUE = int(os.environ.get("BENCH_N_UNIQUE", "4000000"))
STEPS = 8  # chunk steps chained inside one jitted window
N_WINDOWS = 4
BASELINE_SAMPLE_BASES = 2 << 20


def make_read_chunk(rng, n_bases):
    from kmer_mapper_tpu.io.readers import SequenceChunk

    bases = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), n_bases)
    if RAGGED:
        # mixed-length reads (mean = READ_LEN) — the variable-length FASTA
        # regime; defeats the fixed-read_len fast path by construction
        lens = rng.integers(READ_LEN - 50, READ_LEN + 51, 2 * (n_bases // READ_LEN))
        ends = np.cumsum(lens)
        lens = lens[: np.searchsorted(ends, n_bases)]
        starts = (np.cumsum(lens) - lens).astype(np.int64)
        return SequenceChunk(bases=bases[: int(lens.sum())], read_starts=starts)
    n_reads = n_bases // READ_LEN
    starts = np.arange(n_reads, dtype=np.int64) * READ_LEN
    return SequenceChunk(bases=bases[: n_reads * READ_LEN], read_starts=starts)


def resolve_bench_mapper(index, read_len, *, buf, k, revcomp=False):
    """The mapper ``map_file`` would build for the same index, read length
    and device buffer (``pipeline.make_mapper_and_chunks`` with
    ``chunk_size=buf``); pinned equal by ``tests/test_bench_coherence.py``."""
    from kmer_mapper_tpu.models.mapper import KmerMapper, default_config

    config = default_config(
        k=k, buf=buf, max_reads=max(1024, buf // 32), read_len=read_len,
        revcomp=revcomp,
    )
    return KmerMapper(index, config)


def card_name() -> str:
    """``name, power.limit`` of the first GPU, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.splitlines()[0].strip()


def main():
    t0 = time.perf_counter()
    import jax
    import jax.numpy as jnp

    from kmer_mapper_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform!r}")
    enable_compile_cache()
    from kmer_mapper_tpu import oracle
    from kmer_mapper_tpu.index import kmer_index as ki
    from kmer_mapper_tpu.io.readers import pack_for_device
    from kmer_mapper_tpu.models.mapper import chunk_step, plane_chunk_step

    log(f"device: {dev.device_kind} ({card_name()}), jax {jax.__version__}")
    rng = np.random.default_rng(0)

    # --- synthetic data: index keys drawn ~50% from actual read kmers -------
    chunks = [make_read_chunk(rng, BUF) for _ in range(STEPS)]
    t = time.perf_counter()
    sample_codes = oracle.encode_bytes(chunks[0].bases[: READ_LEN * 5000])
    sample_kmers = oracle.kmer_hashes(sample_codes, K)
    entry_kmers = np.unique(
        np.concatenate(
            [
                rng.integers(0, 1 << 62, N_UNIQUE // 2, dtype=np.uint64),
                rng.choice(sample_kmers, N_UNIQUE // 2),
            ]
        )
    )
    nodes = rng.integers(0, 3_000_000, len(entry_kmers)).astype(np.int32)
    index = ki.TpuKmerIndex.from_entries(entry_kmers, nodes)
    table = index.table
    log(
        f"index: {index.n_unique} unique kmers, {table.n_buckets} buckets, "
        f"table {table.nbytes / 1e6:.0f} MB, built in {time.perf_counter() - t:.1f}s"
    )

    # fixed-length synthetic reads ride the word-plane step over strided
    # packing (what the pipeline does for detected fixed-length files);
    # BENCH_RAGGED=1 takes the mixed-length step instead
    read_len = 0 if RAGGED else READ_LEN
    mapper = resolve_bench_mapper(index, read_len, buf=BUF, k=K, revcomp=REVCOMP)
    config = mapper.config
    log(f"config: buf={BUF >> 20}Mi read_len={read_len} accumulate={config.accumulate}")
    use_plane = not RAGGED
    packed = [
        next(iter(pack_for_device(
            iter([c]), config.buf, config.max_reads, K, read_len=read_len,
        )))
        for c in chunks
    ]
    if use_plane:
        assert all(p[5] for p in packed)  # uniform reads -> strided layout
    key_lo, key_hi = mapper.key_lo, mapper.key_hi
    counts = jax.device_put(jnp.zeros(table.n_slots, dtype=jnp.uint32))
    if use_plane:
        resident = [
            (jax.device_put(p), jnp.int32(nb // READ_LEN))
            for p, ln, nb, _, _, _ in packed
        ]
        step = functools.partial(
            plane_chunk_step, config=config, max_probe=table.max_probe,
            seed=table.seed,
        )
    else:
        resident = [
            (jax.device_put(p), jax.device_put(ln), jnp.int32(nb))
            for p, ln, nb, _, _ in packed
        ]
        step = functools.partial(
            chunk_step, config=config, max_probe=table.max_probe, seed=table.seed,
        )

    def window(key_lo, key_hi, counts, resident):
        total = jnp.uint32(0)
        for i in range(STEPS):  # distinct chunks — see methodology note
            counts, n_valid = step(key_lo, key_hi, counts, *resident[i])
            total = total + n_valid
        return counts, total

    window_fn = jax.jit(window, donate_argnums=(2,))
    t = time.perf_counter()
    counts, total = window_fn(key_lo, key_hi, counts, resident)
    kmers_per_window = int(jax.device_get(total))
    log(
        f"compile+first window: {time.perf_counter() - t:.1f}s "
        f"({kmers_per_window} kmers/window)"
    )
    rates = []
    for w in range(N_WINDOWS):
        t = time.perf_counter()
        counts, total = window_fn(key_lo, key_hi, counts, resident)
        _ = int(jax.device_get(total))  # blocks until the window completes
        dt = time.perf_counter() - t
        rates.append(kmers_per_window / dt)
        log(
            f"window {w}: {kmers_per_window} kmers in {dt:.3f}s = "
            f"{rates[-1] / 1e6:.1f} Mkmers/s"
        )
    device_rate = max(rates)

    # --- streaming feed (host -> device each step), for the stderr record --
    mapper.map_chunk(*packed[0][:3], strided=use_plane)
    _ = mapper.n_kmers_mapped
    before = mapper.n_kmers_mapped
    t = time.perf_counter()
    for i in range(4):
        p, ln, nb, _, inv = packed[i % len(packed)][:5]
        mapper.map_chunk(p, ln, nb, inv, strided=use_plane)
    streamed = mapper.n_kmers_mapped - before
    log(f"streaming-feed rate: {streamed / (time.perf_counter() - t) / 1e6:.1f} Mkmers/s")

    # --- baseline: reference-semantics numpy path on host, x16 threads -------
    arrays = oracle.build_kmer_index(
        entry_kmers, nodes, modulo=max(3, int(len(entry_kmers) * 1.7) | 1)
    )
    base_chunk = make_read_chunk(rng, BASELINE_SAMPLE_BASES)
    t = time.perf_counter()
    codes = oracle.encode_bytes(base_chunk.bases)
    hashes = oracle.kmer_hashes_ragged(codes, base_chunk.read_lengths, K)
    n_fwd = len(hashes)
    if REVCOMP:
        # the device rate is fwd kmers/s at 2 lookups each; charge the
        # baseline the same doubled lookup work
        hashes = np.concatenate([hashes, oracle.revcomp_hash(hashes, K)])
    _ = oracle.map_kmers_to_index(arrays, hashes, max_node_id=3_000_000)
    base_dt = time.perf_counter() - t
    base_rate_1core = n_fwd / base_dt
    baseline_rate = base_rate_1core * 16
    log(
        f"baseline (numpy oracle, 1 core): {base_rate_1core / 1e6:.1f} Mkmers/s; "
        f"x16 threads = {baseline_rate / 1e6:.1f} Mkmers/s"
    )
    log(f"total bench time {time.perf_counter() - t0:.1f}s")

    reads_desc = "ragged ~151bp reads" if RAGGED else f"{READ_LEN}bp reads"
    if REVCOMP:
        reads_desc += ", +revcomp lookups"
    print(
        json.dumps(
            {
                "metric": f"kmers hashed+looked-up per second per chip (k={K}, {reads_desc})",
                "value": round(device_rate, 1),
                "unit": "kmers/s",
                "vs_baseline": round(device_rate / baseline_rate, 3),
            }
        )
    )


if __name__ == "__main__":
    main()

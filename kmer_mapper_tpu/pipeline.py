"""End-to-end mapping pipeline: file -> framed chunks -> device step -> node counts.

The driver equivalent of the reference's ``map_bnp``
(``kmer_mapper/command_line_interface.py:82-152``), restructured for an
accelerator:

* The reference's process-pool + POSIX-shared-memory map-reduce
  (``additative_shared_array_map_reduce``, ``:124-130``) becomes a host
  producer thread (read + frame + pack into fixed-shape pinned buffers) feeding
  an asynchronously-dispatched jitted device step through a bounded queue —
  the same producer/consumer backpressure (queue_size_factor) without IPC,
  since the "reduce" is an on-device accumulator.
* All shapes are static, so the step compiles once and chunk N+1's host work
  overlaps chunk N's device work (JAX dispatch is async).
"""
from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Iterable, Iterator

import numpy as np

from .index.kmer_index import TpuKmerIndex, load_index
from .io import readers
from .models.mapper import KmerMapper, MapperConfig, chunk_is_fixed, default_config
from .utils.timing import log_memory_usage_now, span

logger = logging.getLogger(__name__)

#: rough size multiplier for progress estimation of gzipped input
#: (reference heuristic, command_line_interface.py:92-93)
GZIP_EXPANSION = 6.5


def _producer(chunk_iter: Iterator, out_queue: queue.Queue, stop: threading.Event):
    try:
        for item in chunk_iter:
            while not stop.is_set():
                try:
                    out_queue.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue
            if stop.is_set():
                return
        out_queue.put(None)
    except BaseException as exc:  # surface reader errors on the consumer side
        out_queue.put(exc)


def prefetch(iterator: Iterator, depth: int = 4) -> Iterator:
    """Run an iterator in a background thread with bounded lookahead
    (the host-side analog of the reference's queue_size_factor backpressure)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    thread = threading.Thread(target=_producer, args=(iterator, q, stop), daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def map_file(
    index: TpuKmerIndex | str,
    reads_path: str,
    k: int = 31,
    chunk_size: int = 2_500_000,
    max_frequency: int = 1000,
    map_reverse_complements: bool = False,
    accumulate: str = "scatter",
    queue_depth: int = 4,
    progress: bool = True,
    device=None,
    strict_bases: bool = False,
    profile_dir: str | None = None,
    reader_workers: int = 1,
) -> np.ndarray:
    """Map all k-mers of a FASTA/FASTQ(.gz) file against the index; returns the
    per-node hit-count vector (uint32[max_node_id+1]).

    CLI/driver parity: ``map_bnp`` (``command_line_interface.py:82-152``).
    With ``strict_bases`` any non-ACGTN base raises (bionumpy's DNAEncoding
    behavior, SURVEY §3.4); the default encodes them as A with a warning.
    ``profile_dir`` captures a ``jax.profiler`` device trace of the mapping
    loop (one step annotation per chunk) viewable in TensorBoard/Perfetto —
    the structured upgrade of the reference's DEBUG perf_counter spans.
    ``reader_workers`` frames uncompressed input with that many parallel
    host workers (the reference's ``-t``; see ``io/parallel_reader.py``)."""
    t_start = time.perf_counter()
    index = load_index(index)
    mapper, packed = make_mapper_and_chunks(
        index,
        reads_path,
        k=k,
        chunk_size=chunk_size,
        map_reverse_complements=map_reverse_complements,
        accumulate=accumulate,
        device=device,
        reader_workers=reader_workers,
    )

    n_bytes = os.stat(reads_path).st_size
    if reads_path.endswith(".gz"):
        n_bytes = int(n_bytes * GZIP_EXPANSION)
    # bases per raw byte: FASTQ carries quality + headers (~0.48), FASTA ~0.95
    fmt = readers.detect_format(reads_path)
    approx_bases = int(n_bytes * (0.48 if fmt == "fastq" else 0.95))
    approx_chunks = max(1, approx_bases // mapper.config.buf)
    logger.info("N bytes of reads: %d (~%d device buffers)", n_bytes, approx_chunks)

    t_map = time.perf_counter()
    n_chunks = 0
    chunk_iter = prefetch(packed, depth=queue_depth)
    bar = None
    if progress:
        try:  # tqdm progress over estimated chunk count (reference :94,114)
            import tqdm

            bar = tqdm.tqdm(total=max(approx_chunks, 1), unit="chunk", smoothing=0.1)
        except ImportError:
            pass
    import contextlib

    from .utils import profiling

    with profiling.trace(profile_dir) if profile_dir else contextlib.nullcontext():
        for packed_codes, lengths, n_bases, n_reads, n_invalid, strided in chunk_iter:
            if strict_bases and n_invalid:
                raise ValueError(
                    f"{n_invalid} invalid (non-ACGTN) bases in input "
                    "(--strict-bases; the reference's DNAEncoding would raise too)"
                )
            with profiling.step_annotation("map_chunk") if profile_dir else contextlib.nullcontext():
                mapper.map_chunk(packed_codes, lengths, n_bases, n_invalid, strided=strided)
            n_chunks += 1
            if bar is not None:
                bar.update(min(1, bar.total - bar.n))
            elif progress and n_chunks % 200 == 0:
                logger.info(
                    "chunk %d/~%d (%.1f%%)",
                    n_chunks,
                    approx_chunks,
                    100 * min(1.0, n_chunks / approx_chunks),
                )
        if profile_dir:
            _ = mapper.n_kmers_mapped  # drain async work inside the trace
    if bar is not None:
        bar.close()
    n_kmers = mapper.n_kmers_mapped  # blocks until the last dispatched step ran
    logger.info(
        "Time spent only on hashing and counting hashes: %.4f",
        time.perf_counter() - t_map,
    )
    if mapper.n_invalid_bases:
        logger.warning(
            "%d invalid (non-ACGTN) bases were encoded as A", mapper.n_invalid_bases
        )
    with span("node count finalization", logging.INFO):
        node_counts = mapper.node_counts(max_frequency=max_frequency)
    log_memory_usage_now("after mapping")
    n_hits = int(mapper.slot_counts().sum())
    logger.info(
        "Mapped %d kmers (%d index hits, %.1f%%) from %d chunks in %.3f sec total",
        n_kmers,
        n_hits,
        100 * n_hits / max(1, n_kmers),
        n_chunks,
        time.perf_counter() - t_start,
    )
    return node_counts


def device_buffer(chunk_size: int) -> int:
    """Device chunk capacity in bases for a ``chunk_size`` (reads-file bytes
    per chunk): at least 64 Ki bases, at most 64 Mi, a multiple of 8 Ki. The
    GPU size is not tuned yet (it follows the reference's chunk size)."""
    return _round_up(min(max(chunk_size, 1 << 16), 64 << 20), 1 << 13)


def make_mapper_and_chunks(
    index: TpuKmerIndex,
    reads_path: str,
    k: int,
    chunk_size: int,
    map_reverse_complements: bool,
    accumulate: str,
    device=None,
    reader_workers: int = 1,
) -> tuple[KmerMapper, Iterable]:
    """Build the device mapper plus the packed host chunk iterator.

    If the file's reads are uniform-length (the Illumina case — detected from
    a peek at the first records, confirmed per buffer), the step compiles with
    ``read_len`` set and conforming buffers arrive directly in the word-plane
    strided layout from the frame+pack pass (native C++ or numpy — no separate
    restride pass); non-uniform chunks take a ragged twin step with identical
    results."""
    buf = device_buffer(chunk_size)

    def make_config(read_len):
        return default_config(
            k=k,
            buf=buf,
            max_reads=max(1024, buf // 32),
            revcomp=map_reverse_complements,
            accumulate=accumulate,
            read_len=read_len,
        )

    rl_hint = _peek_read_len(reads_path, k)
    chunks = iter(
        packed_chunk_iterator(
            reads_path, make_config(rl_hint), chunk_size, reader_workers
        )
    )
    first = next(chunks, None)
    mapper = KmerMapper(
        index, make_config(rl_hint or _detect_read_len(first, k)), device=device
    )
    if first is None:
        return mapper, iter(())
    import itertools

    return mapper, _strided_chunks(itertools.chain([first], chunks), mapper.config)


def _strided_chunks(packed_iter, config: MapperConfig):
    """Normalize packed chunks to 6-tuples (+``strided``), restriding fixed
    uniform-read_len buffers into the word-plane layout on the fly.

    Producers pack strided when asked up front (``_peek_read_len``); a
    continuous buffer of uniform ``read_len`` reads (the peek missed, but the
    first buffer detected it) is restrided here — inside the prefetch
    thread's pull, so the host word shifts overlap device compute. Buffers
    that are not uniform ``read_len`` reads pass through continuous and take
    the ragged step (identical results)."""
    rows = readers.strided_rows(config.buf, config.read_len) if config.read_len else 0
    for tup in packed_iter:
        if len(tup) == 6:  # pack_for_device(read_len=...) already decided
            yield tup
            continue
        packed, lengths, n_bases, n_reads, n_invalid = tup
        strided = bool(config.read_len) and chunk_is_fixed(
            lengths, n_bases, config.read_len
        )
        if strided:
            packed = readers.restride_packed(
                packed, n_bases // config.read_len, config.read_len, rows
            )
        yield packed, lengths, n_bases, n_reads, n_invalid, strided


def packed_chunk_iterator(
    reads_path: str, config: MapperConfig, chunk_size: int, reader_workers: int = 1
):
    """Framed + packed device buffers for a reads file: the native C++ loader
    when available (see ``io/native.py``), else the numpy framer. Both are
    bit-identical.

    ``reader_workers > 1`` frames an uncompressed file as that many
    byte-region workers in parallel (``io/parallel_reader.py``) — the host
    analog of the reference's ``-t`` process pool. Chunk boundaries then
    differ from the sequential reader's (each region packs greedily from its
    own record-aligned start) but every buffer maps independently and counts
    are additive, so results are identical. Gzipped inputs stay sequential
    (not seekable; BGZF decode is already multi-core)."""
    from .io import native as native_mod

    fmt = readers.detect_format(reads_path)

    def stream_iter(stream):
        if native_mod.available():
            yield from native_mod.pack_stream_native(
                stream, fmt, config.buf, config.max_reads, config.k,
                block_bytes=chunk_size, read_len=config.read_len,
            )
            return
        try:
            chunks = readers.read_chunks(stream, fmt=fmt, min_chunk_size=chunk_size)
            yield from readers.pack_for_device(
                chunks, config.buf, config.max_reads, config.k,
                read_len=config.read_len,
            )
        finally:
            stream.close()

    if reader_workers > 1 and not str(reads_path).endswith(".gz"):
        from .io import parallel_reader

        return parallel_reader.parallel_packed_iterator(
            reads_path,
            fmt,
            lambda region: stream_iter(
                parallel_reader.RangeReader(reads_path, *region)
            ),
            reader_workers,
        )
    return stream_iter(readers.open_bytes(reads_path))


def map_file_sharded(
    index: TpuKmerIndex | str,
    reads_path: str,
    k: int = 31,
    chunk_size: int = 2_500_000,
    max_frequency: int = 1000,
    map_reverse_complements: bool = False,
    index_parallel: int = 1,
    n_devices: int | None = None,
    queue_depth: int = 4,
    strict_bases: bool = False,
    profile_dir: str | None = None,
    reader_workers: int = 1,
) -> np.ndarray:
    """Multi-device mapping over a (data, index) mesh: chunks fan out over the
    data axis, the table shards over the index axis (for multi-GB indexes),
    counts are combined on device at finalization. Single-host multi-device; for
    multi-host, run one pipeline per host on its own file shard and sum the
    node-count vectors. ``strict_bases``/``profile_dir``/``reader_workers``
    as in ``map_file`` — multi-device feeds are where one framing core stops
    being enough."""
    import contextlib

    from .parallel import ShardedKmerMapper, batch_packed_chunks, make_mesh
    from .utils import profiling

    index = load_index(index)
    mesh = make_mesh(n_devices=n_devices, index_parallel=index_parallel)
    buf = device_buffer(chunk_size)

    def make_config(read_len):
        return default_config(
            k=k,
            buf=buf,
            max_reads=max(1024, buf // 32),
            revcomp=map_reverse_complements,
            read_len=read_len,
        )

    config = make_config(0)
    packed = iter(
        packed_chunk_iterator(reads_path, config, chunk_size, reader_workers)
    )
    # same uniform-read-length detection as map_file; batches that break
    # uniformity later take the sharded mapper's ragged twin step
    first = next(packed, None)
    if first is not None:
        import itertools

        packed = itertools.chain([first], packed)
        config = make_config(_detect_read_len(first, k))
    mapper = ShardedKmerMapper(index, config, mesh)
    batches = batch_packed_chunks(
        packed, mapper.n_data, config.packed_words, config.max_reads
    )
    t = time.perf_counter()
    n_batches = 0
    with profiling.trace(profile_dir) if profile_dir else contextlib.nullcontext():
        for batch in prefetch(batches, depth=queue_depth):
            if strict_bases and batch[3]:
                raise ValueError(
                    f"{batch[3]} invalid (non-ACGTN) bases in input "
                    "(--strict-bases; the reference's DNAEncoding would raise too)"
                )
            mapper.map_batch(*batch)
            n_batches += 1
        if profile_dir:
            _ = mapper.n_kmers_mapped
    logger.info(
        "Mapped %d kmers in %d batches over mesh %s in %.3f sec",
        mapper.n_kmers_mapped,
        n_batches,
        dict(mesh.shape),
        time.perf_counter() - t,
    )
    return mapper.node_counts(max_frequency=max_frequency)


def map_sequences(
    index: TpuKmerIndex,
    sequences: list[str],
    k: int = 31,
    max_frequency: int = 1000,
    **kwargs,
) -> np.ndarray:
    """Programmatic API: map in-memory sequences (library parity with calling
    ``map_bnp`` with an in-memory index + small input)."""
    flat = "".join(sequences)
    chunk = readers.SequenceChunk(
        bases=np.frombuffer(flat.encode(), dtype=np.uint8),
        read_starts=(np.cumsum([0] + [len(s) for s in sequences[:-1]])).astype(np.int64),
    )
    buf = _round_up(max(len(flat), 1 << 10), 1 << 10)
    config = default_config(k=k, buf=buf, max_reads=max(16, len(sequences)), **kwargs)
    mapper = KmerMapper(index, config)
    for packed, lengths, n_bases, _, n_invalid in readers.pack_for_device(
        iter([chunk]), config.buf, config.max_reads, config.k
    ):
        mapper.map_chunk(packed, lengths, n_bases, n_invalid)
    return mapper.node_counts(max_frequency=max_frequency)


def _detect_read_len(first_chunk, k: int) -> int:
    """Uniform read length of a packed chunk (0 if ragged/empty/too short):
    decides whether the step compiles with the fixed-read_len window slicing
    (the Illumina case; see MapperConfig.read_len)."""
    if first_chunk is None:
        return 0
    _, lengths, n_bases, n_reads, _ = first_chunk[:5]
    L = int(lengths[0]) if n_reads else 0
    if L >= k and n_bases == n_reads * L and np.all(lengths[:n_reads] == L):
        return L
    return 0


def _peek_read_len(reads_path: str, k: int, peek_bytes: int = 512 << 10) -> int:
    """Uniform read length of the file's FIRST records (0 if ragged, empty,
    unreadable, or shorter than k): frames the first ``peek_bytes`` of
    (decompressed) input host-side so the packers can be asked for the
    word-plane strided layout from buffer one — the C++ frame+pack pass then
    emits it directly, with per-buffer conformance still re-checked (a
    nonconforming buffer anywhere falls back to the continuous layout and the
    mapper's ragged twin step; results are identical either way)."""
    try:
        stream = readers.open_bytes(reads_path)
        try:
            block = stream.read(peek_bytes)
        finally:
            stream.close()
        fmt = readers.detect_format(reads_path, peek=block[:1])
        framer = readers._FastaFramer() if fmt == "fasta" else readers._FastqFramer()
        chunk, _ = framer.frame(
            np.frombuffer(block, dtype=np.uint8), eof=len(block) < peek_bytes
        )
    except (OSError, ValueError):
        return 0
    if chunk.n_reads == 0:
        return 0
    lengths = chunk.read_lengths
    L = int(lengths[0])
    return L if L >= k and np.all(lengths == L) else 0


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m

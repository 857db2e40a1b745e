"""Multi-core host framing: byte-region-parallel frame+pack workers.

The reference parallelizes its whole pipeline with a 16-process pool fed by
POSIX shared memory (``kmer_mapper/command_line_interface.py:124-130``,
``-t/--n-threads``). Here device compute replaces the pool's mapping work,
but host framing+packing is still one core's worth by default, and a fast
device (or several) can outrun one framing core, so this module gives ``-t``
its production meaning:

* An uncompressed FASTA/FASTQ file is split into ``n_workers`` byte regions,
  each region starting exactly at a record boundary (``split_regions``).
* Each worker runs the ordinary frame+pack iterator (native C++ loader or
  numpy fallback — whatever ``packed_chunk_iterator`` would use) over its own
  region and pushes finished device buffers into one bounded queue. The
  native framer's encode/pack loop runs outside the GIL (ctypes), so threads
  scale across cores without IPC.
* Buffers are consumed in completion order. Chunk boundaries differ from the
  sequential reader's (each region packs greedily from its own start), but
  every buffer is mapped independently and counts are additive, so node
  counts are bit-identical to a sequential run (tests enforce).

Gzipped inputs keep the sequential path (a gzip stream is not seekable; BGZF
decode is already multi-core inside ``io/gzio.py``). Each worker holds its
own framing window (~3x the buffer's byte size for the native loader), so
memory scales with ``n_workers`` — the CLI caps workers at the host's core
count.

Record-boundary search: FASTA records start at ``\\n>``. FASTQ needs
disambiguation (quality lines may begin with ``@``): a candidate ``\\n@`` is
accepted only if the 4-line record pattern holds from it (header ``@``,
separator ``+``, len(qual) == len(seq)) — the standard splitter heuristic
(bwa/seqkit). A wrong split cannot corrupt counts silently: the worker's
framer raises on the malformed record instead.
"""
from __future__ import annotations

import io
import logging
import os
import queue
import threading
from typing import Iterator

logger = logging.getLogger(__name__)

_PROBE = 1 << 16
#: give up splitting at a target offset after scanning this many bytes
#: without a provable record start (region merges into the previous one)
_PROBE_BOUND = 1 << 26


def _fastq_record_at(lines: list[bytes], i: int) -> bool:
    """Do lines[i:i+4] look like a complete FASTQ record? (header '@',
    separator '+', quality length == sequence length)."""
    if i + 3 >= len(lines):
        return False
    head, seq, plus, qual = lines[i : i + 4]
    return (
        head.startswith(b"@")
        and plus.startswith(b"+")
        and not seq.startswith(b"+")
        and len(_strip_cr(qual)) == len(_strip_cr(seq))
    )


def _strip_cr(line: bytes) -> bytes:
    return line[:-1] if line.endswith(b"\r") else line


def _find_record_start(chunk: bytes, fmt: str, at_file_start: bool) -> int | None:
    """Offset of the first record start at or after position 0 of ``chunk``,
    or None when ``chunk`` holds no provable record start (caller extends the
    probe). ``at_file_start`` lets offset 0 qualify without a preceding
    newline."""
    if fmt == "fasta":
        if at_file_start and chunk.startswith(b">"):
            return 0
        pos = chunk.find(b"\n>")
        return None if pos < 0 else pos + 1
    # FASTQ: validate the 4-line pattern from each candidate header line.
    # Split once; candidate k is a line starting with '@' whose next lines
    # complete a record. The final (partial) split element is never a
    # candidate — without its terminating newline the pattern can't be
    # proven, so the caller extends the probe instead.
    lines = chunk.split(b"\n")
    offset = 0
    for i, line in enumerate(lines[:-1]):
        if (
            line.startswith(b"@")
            and (i > 0 or at_file_start)
            and _fastq_record_at(lines, i)
        ):
            return offset
        offset += len(line) + 1
    return None


def split_regions(
    path: str, fmt: str, n_regions: int, min_region: int | None = None
) -> list[tuple[int, int]]:
    """Partition ``path`` into up to ``n_regions`` byte ranges, each starting
    exactly at a record boundary. Exhaustive and disjoint: every byte belongs
    to exactly one region, so the union of the regions' records is the file's.
    Files smaller than ``min_region`` per worker take fewer regions."""
    size = os.path.getsize(path)
    if min_region is None:
        min_region = _PROBE  # resolved at call time so tests can shrink it
    n_regions = max(1, min(n_regions, max(1, size // min_region)))
    if n_regions == 1:
        return [(0, size)]
    starts = [0]
    with open(path, "rb") as f:
        for i in range(1, n_regions):
            target = size * i // n_regions
            if target <= starts[-1]:
                continue
            f.seek(target)
            probe = b""
            found = None
            while found is None:
                block = f.read(_PROBE)
                if not block:
                    break  # no record start before EOF: tail joins the prior region
                probe += block
                found = _find_record_start(probe, fmt, at_file_start=False)
                # No record start within the probe bound — e.g. the target
                # landed inside a genome-scale FASTA record (a chromosome can
                # be hundreds of MB) or a pathological FASTQ. Skip this
                # boundary: the region merges into the previous worker's
                # (correctness unaffected, parallelism degrades only as much
                # as the record sizes force), and later targets still split.
                if found is None and len(probe) > _PROBE_BOUND:
                    logger.debug(
                        "no record boundary within 64 MiB after offset %d; "
                        "merging region", target,
                    )
                    break
            if found is not None and target + found > starts[-1]:
                starts.append(target + found)
    starts.append(size)
    return [(starts[i], starts[i + 1]) for i in range(len(starts) - 1)]


class RangeReader(io.RawIOBase):
    """Sequential reads over one byte range of a file (its own descriptor,
    so workers never share seek positions)."""

    def __init__(self, path: str, start: int, end: int):
        self._f = open(path, "rb")
        self._f.seek(start)
        self._left = end - start

    def read(self, n: int = -1) -> bytes:
        if self._left <= 0:
            return b""
        n = self._left if n is None or n < 0 else min(n, self._left)
        block = self._f.read(n)
        self._left -= len(block)
        return block

    def readable(self) -> bool:
        return True

    def close(self):
        try:
            self._f.close()
        finally:
            super().close()


def parallel_packed_iterator(
    reads_path: str,
    fmt: str,
    make_region_iter,
    n_workers: int,
    queue_depth: int = 2,
    min_region: int | None = None,
) -> Iterator[tuple]:
    """Run ``make_region_iter((start, end)) -> iterator of packed buffers``
    over each region in its own thread; yield buffers in completion order.

    ``queue_depth`` bounds in-flight finished buffers PER WORKER (host memory
    backpressure, the parallel analog of ``pipeline.prefetch``'s depth)."""
    regions = split_regions(reads_path, fmt, n_workers, min_region)
    if len(regions) == 1:
        yield from make_region_iter(regions[0])
        return
    out: queue.Queue = queue.Queue(maxsize=max(2, queue_depth * len(regions)))
    stop = threading.Event()
    _DONE = object()

    def worker(region):
        try:
            for item in make_region_iter(region):
                while not stop.is_set():
                    try:
                        out.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            out.put(_DONE)
        except BaseException as exc:  # propagate into the consumer
            out.put(exc)

    threads = [
        threading.Thread(target=worker, args=(r,), daemon=True) for r in regions
    ]
    for t in threads:
        t.start()
    live = len(threads)
    try:
        while live:
            item = out.get()
            if item is _DONE:
                live -= 1
                continue
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()

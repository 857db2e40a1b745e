"""Command-line interface.

Flag-compatible with the reference CLI (``kmer_mapper map``,
``command_line_interface.py:155-192``):

    kmer_mapper_tpu map -i index.npz -f reads.fa -o counts -k 31

Differences, deliberate:

* ``--max-hits-per-kmer`` is actually honored (the reference parses it but the
  worker never forwards it, so the Cython default 1000 always applied —
  ``command_line_interface.py:173-174`` vs ``map_cpu:51``; default here is the
  same 1000, so default behavior matches bit-for-bit).
* boolean flags accept true/false strings but are parsed robustly (the
  reference's ``type=bool`` makes any non-empty string truthy).
* ``--gpu`` is accepted for drop-in compatibility and ignored: JAX's default
  device (the GPU) runs the mapping.
* extra subcommand ``convert-index`` prebuilds the device table layout so
  large indexes skip re-layout on every run.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys

import numpy as np

logging.basicConfig(
    stream=sys.stdout, level=logging.INFO, format="%(asctime)s %(levelname)s: %(message)s"
)
logger = logging.getLogger(__name__)


def _parse_bool(value) -> bool:
    if isinstance(value, bool):
        return value
    return str(value).strip().lower() in ("1", "true", "yes", "y", "t")


def main(argv=None):
    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    run_argument_parser(sys.argv[1:] if argv is None else argv)


def run_argument_parser(args):
    parser = argparse.ArgumentParser(
        description="Kmer Mapper on JAX",
        prog="kmer_mapper_tpu",
        formatter_class=lambda prog: argparse.HelpFormatter(
            prog, max_help_position=50, width=100
        ),
    )
    subparsers = parser.add_subparsers()

    sub = subparsers.add_parser("map", help="Map reads to a kmer index")
    sub.add_argument("-i", "--kmer-index", required=False)
    sub.add_argument("-b", "--index-bundle", required=False)
    sub.add_argument(
        "-f", "--reads", required=True, help="Reads in .fa, .fq, .fa.gz, or .fq.gz format"
    )
    sub.add_argument("-k", "--kmer-size", required=False, default=31, type=int)
    sub.add_argument(
        "-t",
        "--n-threads",
        required=False,
        default=16,
        type=int,
        help="Parallel host framing workers for uncompressed input, capped at "
        "the core count (the device does the counting; also sets prefetch depth)",
    )
    sub.add_argument(
        "-c",
        "--chunk-size",
        required=False,
        type=int,
        default=2_500_000,
        help="N bytes to process in each chunk",
    )
    sub.add_argument("-o", "--output-file", required=True)
    sub.add_argument("-d", "--debug", required=False, default=False)
    sub.add_argument(
        "-I",
        "--max-hits-per-kmer",
        required=False,
        default=1000,
        type=int,
        help="Ignore index kmers with more than this many hits in the index",
    )
    sub.add_argument(
        "-g", "--gpu", default=False, help="Ignored (accelerator is used automatically)"
    )
    sub.add_argument(
        "-s",
        "--gpu-hash-map-size",
        default=0,
        type=int,
        help="Ignored (table size is derived from the index at load time)",
    )
    sub.add_argument(
        "-r",
        "--map-reverse-complements",
        default=False,
        help="Also count kmers of the reverse complement of each read",
    )
    sub.add_argument(
        "--accumulate",
        default="scatter",
        choices=["scatter", "sorted"],
        help="Gather-probe count accumulation strategy",
    )
    sub.add_argument(
        "--profile-dir",
        default=None,
        help="Write a jax.profiler device trace of the mapping loop here "
        "(view in TensorBoard/Perfetto)",
    )
    sub.add_argument(
        "--strict-bases",
        action="store_true",
        help="Raise on non-ACGTN input bases (bionumpy DNAEncoding behavior) "
        "instead of encoding them as A with a warning",
    )
    sub.add_argument(
        "--n-devices",
        default=None,
        type=int,
        help="Map over this many accelerator devices (default: 1)",
    )
    sub.add_argument(
        "--index-parallel",
        default=1,
        type=int,
        help="Shard the index table over this many devices (multi-GB indexes)",
    )
    sub.set_defaults(func=_cmd_map)

    conv = subparsers.add_parser(
        "convert-index", help="Prebuild the device table layout from a reference .npz index"
    )
    conv.add_argument("-i", "--kmer-index", required=True)
    conv.add_argument("-o", "--output-file", required=True)
    conv.set_defaults(func=_cmd_convert_index)

    if len(args) == 0:
        parser.print_help()
        sys.exit(1)
    parsed = parser.parse_args(args)
    if not hasattr(parsed, "func"):
        parser.print_help()
        sys.exit(1)
    return parsed.func(parsed)


def _resolve_index_arg(args):
    """Reference index resolution precedence (``util.py:38-68``)."""
    from .index.kmer_index import load_index

    if args.kmer_index is None and args.index_bundle is None:
        logger.error("Either a kmer index (-i) or an index bundle (-b) needs to be specified")
        sys.exit(1)
    return load_index(args.kmer_index if args.kmer_index is not None else args.index_bundle)


def _cmd_map(args):
    if not 1 <= args.kmer_size <= 31:
        logger.error("kmer size must be in [1, 31] (62-bit hashes); got %d", args.kmer_size)
        sys.exit(1)
    if _parse_bool(args.debug):
        logging.getLogger().setLevel(logging.DEBUG)
        logger.info("Will print debug log")
    from . import pipeline

    index = _resolve_index_arg(args)
    # -t maps to parallel host framing workers, capped at the core count so
    # the reference's default (-t 16) never over-threads a small host
    reader_workers = max(1, min(args.n_threads, os.cpu_count() or 1))
    multi = (args.n_devices or 1) > 1 or args.index_parallel > 1
    if multi:
        node_counts = pipeline.map_file_sharded(
            index,
            args.reads,
            k=args.kmer_size,
            chunk_size=args.chunk_size,
            max_frequency=args.max_hits_per_kmer,
            map_reverse_complements=_parse_bool(args.map_reverse_complements),
            index_parallel=args.index_parallel,
            n_devices=args.n_devices,
            queue_depth=max(2, min(args.n_threads, 16)),
            strict_bases=args.strict_bases,
            profile_dir=args.profile_dir,
            reader_workers=reader_workers,
        )
    else:
        node_counts = pipeline.map_file(
            index,
            args.reads,
            k=args.kmer_size,
            chunk_size=args.chunk_size,
            max_frequency=args.max_hits_per_kmer,
            map_reverse_complements=_parse_bool(args.map_reverse_complements),
            accumulate=args.accumulate,
            queue_depth=max(2, min(args.n_threads, 16)),
            strict_bases=args.strict_bases,
            profile_dir=args.profile_dir,
            reader_workers=reader_workers,
        )
    if args.output_file is None:
        return node_counts
    np.save(args.output_file, node_counts)
    # np.save only appends .npy when the path does not already end with it
    saved = args.output_file if str(args.output_file).endswith(".npy") else f"{args.output_file}.npy"
    logger.info("Saved node counts to %s", saved)
    return None


def _cmd_convert_index(args):
    from .index.kmer_index import load_index

    index = load_index(args.kmer_index)
    out = args.output_file
    if not out.endswith(".npz"):
        out += ".npz"
    index.to_file(out)
    logger.info(
        "Wrote prebuilt index (%d unique kmers, %d buckets) to %s",
        index.n_unique,
        index.table.n_buckets,
        out,
    )


if __name__ == "__main__":
    main()

"""Drop-in module-path alias for ``kmer_mapper.command_line_interface``.

The reference exposes ``main`` / ``run_argument_parser`` and the driver
``map_bnp(args)`` (``kmer_mapper/command_line_interface.py:28,82,155``); this
module maps them onto this package's CLI so programmatic callers survive the package
rename. ``map_bnp`` accepts the reference's parsed-args object (including an
in-memory ``kmer_index``) and returns the node counts when ``output_file`` is
None, exactly like the reference.
"""
from __future__ import annotations

from .cli import main, run_argument_parser


def map_bnp(args):
    """Reference driver-signature parity (``command_line_interface.py:82-152``):
    run the mapping described by a parsed-args namespace."""
    from . import pipeline
    from .util import _get_kmer_index_from_args

    import numpy as np

    # -i / -b / in-memory precedence as in the reference (util.py:38-68)
    index = _get_kmer_index_from_args(args)
    node_counts = pipeline.map_file(
        index,
        args.reads,
        k=getattr(args, "kmer_size", 31),
        chunk_size=getattr(args, "chunk_size", 2_500_000),
        max_frequency=getattr(args, "max_hits_per_kmer", 1000),
        map_reverse_complements=bool(getattr(args, "map_reverse_complements", False)),
    )
    output_file = getattr(args, "output_file", None)
    if output_file is None:
        return node_counts
    np.save(output_file, node_counts)
    return None


def map_cpu(args, kmer_index, chunk_sequence):
    """Reference worker parity (``command_line_interface.py:32-56``): map one
    chunk of sequences against the index, returning the partial count vector
    the caller sums.

    Deliberate difference: there is no POSIX-shm pool here (the reference's
    ``shared_memory_wrapper`` becomes the prefetch pipeline, SURVEY §2), so
    the third argument is the chunk itself — a list of str/bytes sequences or
    a (bases, lengths) pair — rather than a shared-memory name. N→A
    substitution happens inside the hasher, exactly as the reference does it
    before hashing (``:40-41``)."""
    from .compat import _as_device_index, map_kmers_to_graph_index
    from .util import get_kmer_hashes_from_chunk_sequence

    kmer_size = (
        args["kmer_size"] if isinstance(args, dict)
        else getattr(args, "kmer_size", 31)
    )
    hashes = get_kmer_hashes_from_chunk_sequence(chunk_sequence, kmer_size)
    dev_index = _as_device_index(kmer_index)
    return map_kmers_to_graph_index(dev_index, dev_index.max_node_id, hashes)


def map_gpu(index, chunks, k, hash_map_size=0, map_reverse_complements=False):
    """Reference GPU-loop parity (``command_line_interface.py:59-79``) on the
    accelerator counter: build the counter from the index's (kmers, nodes),
    count every chunk's hashes (optionally with on-device reverse
    complements), convert to node counts. ``chunks`` yields objects with a
    ``.sequence`` (reference shape) or raw sequence lists."""
    import numpy as np

    from .compat import TpuCounter, _as_device_index
    from .util import get_kmer_hashes_from_chunk_sequence

    kmers = getattr(index, "_kmers", None)
    nodes = getattr(index, "_nodes", None)
    if kmers is None or nodes is None:
        from .ops.u32hash import feistel_unmix, join_u64

        dev_index = _as_device_index(index)
        m_lo, m_hi = dev_index.table.key_words()
        slot = dev_index.entry_slot
        kmers = join_u64(
            *feistel_unmix(m_lo[slot], m_hi[slot], seed=dev_index.table.seed)
        )
        nodes = dev_index.entry_node
    kmers = np.asarray(kmers, dtype=np.uint64)
    nodes = np.asarray(nodes)
    counter = TpuCounter.from_kmers_and_nodes(kmers, nodes, k)
    counter.initialize_cuda(hash_map_size)
    for chunk in chunks:
        seqs = getattr(chunk, "sequence", chunk)
        hashes = get_kmer_hashes_from_chunk_sequence(seqs, k)
        counter.count(hashes, count_revcomps=map_reverse_complements)
    min_nodes = int(nodes.max()) if len(nodes) else 0
    return counter.get_node_counts(min_nodes=min_nodes)


__all__ = ["main", "run_argument_parser", "map_bnp", "map_cpu", "map_gpu"]

"""Literal drop-in import path for the reference package.

KAGE and other callers of ivargr/kmer_mapper import ``kmer_mapper.mapper``,
``kmer_mapper.util``, ``kmer_mapper.command_line_interface``,
``kmer_mapper.gpu_counter`` and ``kmer_mapper.encodings``
(reference ``setup.py:20-24`` packages exactly these modules). This package
provides the same module paths, each a thin re-export of the corresponding
``kmer_mapper_tpu`` module, so switching to this framework requires ZERO
import edits.

The reference's own ``__init__.py`` is empty (``kmer_mapper/__init__.py``);
this one stays side-effect-free too — importing it must not pull in jax.

Clash guard: if a different (real) ``kmer_mapper`` distribution is installed
in the same environment, Python's import system resolves only one of them —
``kmer_mapper.IS_TPU_DROP_IN`` lets callers and tests detect which one won.
"""

IS_TPU_DROP_IN = True

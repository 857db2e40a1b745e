"""DNA encoding: ASCII bytes <-> 2-bit codes, host pack + device unpack.

Replaces bionumpy's ``as_encoded_array(..., DNAEncoding)`` (reference
``kmer_mapper/util.py:72``). N/n encode to A (code 0), matching the
reference's N->A substitution (``command_line_interface.py:40-41``); other
invalid bytes are counted (the reference would raise).

The host packs 16 bases per uint32 word before transfer — 4x less
host->device traffic than raw ASCII over PCIe. The device unpacks with one
vectorized shift/mask pass that XLA fuses into the rolling hash.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import oracle

BASES_PER_WORD = 16

_CODE_TABLE = oracle.CODE_TABLE  # 255 = invalid
_HOST_SHIFTS = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32)).astype(np.uint32)

# device tables for the pure-device encode path (kept for API completeness)
_DEV_CODE = np.where(_CODE_TABLE == oracle.INVALID_CODE, 0, _CODE_TABLE).astype(np.uint8)
_DEV_INVALID = (_CODE_TABLE == oracle.INVALID_CODE).astype(np.uint8)


def host_encode_pack(bases: np.ndarray, out_words: int) -> tuple[np.ndarray, int]:
    """ASCII bases -> (packed uint32[out_words], n_invalid). Invalid bases
    (non-ACGTN) are encoded as A and counted."""
    codes = _CODE_TABLE[np.asarray(bases, dtype=np.uint8)]
    invalid = codes == oracle.INVALID_CODE
    n_invalid = int(invalid.sum())
    if n_invalid:
        codes = np.where(invalid, 0, codes)
    n = len(codes)
    assert n <= out_words * BASES_PER_WORD
    padded = np.zeros(out_words * BASES_PER_WORD, dtype=np.uint32)
    padded[:n] = codes
    packed = np.bitwise_or.reduce(
        padded.reshape(-1, BASES_PER_WORD) << _HOST_SHIFTS, axis=1
    ).astype(np.uint32)
    return packed, n_invalid


def unpack_codes(packed: jnp.ndarray) -> jnp.ndarray:
    """uint32[w] -> uint32[w*16] 2-bit codes (device side)."""
    shifts = jnp.arange(BASES_PER_WORD, dtype=jnp.uint32) * 2
    return ((packed[:, None] >> shifts[None, :]) & jnp.uint32(3)).reshape(-1)


def encode_bases(ascii_u8: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Pure-device encode: (codes uint32 in 0..3, invalid uint8 flags)."""
    codes = jnp.asarray(_DEV_CODE)[ascii_u8].astype(jnp.uint32)
    invalid = jnp.asarray(_DEV_INVALID)[ascii_u8]
    return codes, invalid

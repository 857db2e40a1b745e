"""Index loading and the device-resident index structure.

Input formats mirror the reference's index resolution
(``kmer_mapper/util.py:38-68``):

1. a ``graph_kmer_index.KmerIndex``-format ``.npz`` (fields ``hashes_to_index``,
   ``n_kmers``, ``kmers``, ``nodes``, ``frequencies``, ``modulo``; leading
   underscores tolerated; ``ref_offsets`` dropped on load = the reference's
   ``remove_ref_offsets()``; node dtype narrowed to int32 = ``convert_to_int32()``),
2. a "minimal" index (same, possibly missing ``frequencies`` -> treated as 1),
3. a counter-style index (fields ``counter_keys`` unique kmers [+ optional
   ``kmers``/``nodes`` for node conversion]) — the ``CounterKmerIndex`` analog,
4. an index bundle: a zip/npz containing a ``kmer_index`` member
   (``graph_kmer_index.IndexBundle`` analog),
5. this package's own prebuilt ``.tpuidx.npz`` (table + finalization arrays),
   which skips the re-layout cost on reload.

Whatever the input, loading produces a :class:`TpuKmerIndex`: the block-chained
bucket table of *unique* kmers (see ``layout.py``) plus the per-entry
finalization arrays used to turn unique-kmer counts into graph-node counts with
the reference's exact per-entry frequency-filter semantics
(``kmer_mapper/mapper.pyx:58-68``).
"""
from __future__ import annotations

import dataclasses
import io
import logging
import os
import zipfile

import numpy as np

from ..oracle import KmerIndexArrays, build_kmer_index
from . import layout

logger = logging.getLogger(__name__)

_REF_FIELDS = ("hashes_to_index", "n_kmers", "kmers", "nodes", "frequencies", "modulo")


def _npz_get(data, name):
    for key in (name, "_" + name):
        if key in data:
            try:
                return data[key]
            except ValueError:
                # a None attribute written by the real ``to_file`` becomes a
                # 0-d object array, unreadable under allow_pickle=False —
                # treat as absent (e.g. an index saved without frequencies),
                # but keep trying the "_"-prefixed twin: a file can carry a
                # None-valued plain field alongside a real underscored one
                continue
    return None


def load_reference_npz(path_or_file) -> KmerIndexArrays:
    """Load a ``graph_kmer_index`` KmerIndex/MinimalKmerIndex ``.npz``."""
    with np.load(path_or_file, allow_pickle=False) as data:
        fields = {name: _npz_get(data, name) for name in _REF_FIELDS}
    if fields["kmers"] is None or fields["hashes_to_index"] is None:
        raise ValueError("not a KmerIndex .npz (missing kmers/hashes_to_index)")
    n = len(fields["kmers"])
    if fields["frequencies"] is None:
        fields["frequencies"] = np.ones(n, dtype=np.uint16)  # minimal index form
    if fields["n_kmers"] is None:
        # bucket lengths are derivable from consecutive bucket start offsets
        # (best effort; only the oracle probe uses them — the device layout is
        # rebuilt from the entry arrays regardless)
        starts = fields["hashes_to_index"].astype(np.int64)
        fields["n_kmers"] = np.maximum(np.diff(np.append(starts, n)), 0)
    modulo = int(np.asarray(fields["modulo"]).reshape(-1)[0])
    return KmerIndexArrays(
        hashes_to_index=fields["hashes_to_index"].astype(np.int32),
        n_kmers=fields["n_kmers"].astype(np.int32),
        kmers=fields["kmers"].astype(np.uint64),
        nodes=fields["nodes"].astype(np.int32),
        frequencies=fields["frequencies"].astype(np.uint16),
        modulo=modulo,
    )


def save_reference_npz(path, index: KmerIndexArrays) -> None:
    """Write the reference-compatible ``.npz`` layout (for interop and tests)."""
    np.savez(
        path,
        hashes_to_index=index.hashes_to_index,
        n_kmers=index.n_kmers,
        kmers=index.kmers,
        nodes=index.nodes,
        frequencies=index.frequencies,
        modulo=np.uint64(index.modulo),
    )


@dataclasses.dataclass
class TpuKmerIndex:
    """Device-ready index: unique-kmer table + entry finalization arrays."""

    table: layout.TableArrays
    # per-entry arrays (an index entry = one (kmer, node) pair; kmers may repeat)
    entry_slot: np.ndarray  # int32[N] global table slot of the entry's kmer
    entry_node: np.ndarray  # int32[N]
    entry_frequency: np.ndarray  # uint16[N]
    max_node_id: int
    # unique kmers in slot order are implied by the table; kept for counter APIs
    n_unique: int

    @classmethod
    def from_arrays(
        cls, index: KmerIndexArrays, max_load: float = layout.DEFAULT_MAX_LOAD
    ) -> "TpuKmerIndex":
        return cls.from_entries(
            index.kmers, index.nodes, index.frequencies, max_load=max_load
        )

    @classmethod
    def from_entries(
        cls,
        kmers: np.ndarray,
        nodes: np.ndarray,
        frequencies: np.ndarray | None = None,
        max_load: float = layout.DEFAULT_MAX_LOAD,
        extra_keys: np.ndarray | None = None,
    ) -> "TpuKmerIndex":
        """Build from (kmer, node) entry pairs. ``extra_keys`` are additional
        countable kmers with no node mapping (a CounterKmerIndex may count
        keys that carry no entry); they are probeable and appear in
        ``kmer_counts`` but contribute to no node."""
        kmers = np.asarray(kmers, dtype=np.uint64)
        nodes = np.asarray(nodes, dtype=np.int32)
        all_keys = kmers
        if extra_keys is not None and len(extra_keys):
            all_keys = np.concatenate([kmers, np.asarray(extra_keys, np.uint64)])
        # one unique pass: the inverse maps entries to unique keys, and the
        # table build records each unique key's slot — so entry slots come
        # from two gathers instead of re-probing every entry (which dominated
        # build time at 10M+ keys)
        unique, inverse = np.unique(all_keys, return_inverse=True)
        inverse = inverse[: len(kmers)]
        if frequencies is None:
            counts = np.bincount(inverse, minlength=len(unique))
            frequencies = np.minimum(counts[inverse], 65535).astype(np.uint16)
        table = layout.build_table(unique, max_load=max_load)
        entry_slot = table.build_slots[inverse]
        table.build_slots = None  # build byproduct; ~8 B/key not needed again
        return cls(
            table=table,
            entry_slot=entry_slot.astype(np.int32),
            entry_node=nodes,
            entry_frequency=np.asarray(frequencies, dtype=np.uint16),
            max_node_id=int(nodes.max()) if len(nodes) else 0,
            n_unique=len(unique),
        )

    @classmethod
    def from_counter_keys(cls, unique_kmers: np.ndarray) -> "TpuKmerIndex":
        """Counter-only index (no node mapping): counts unique kmers."""
        unique = np.unique(np.asarray(unique_kmers, dtype=np.uint64))
        table = layout.build_table(unique)
        slot = table.build_slots
        table.build_slots = None
        return cls(
            table=table,
            entry_slot=slot.astype(np.int32),
            entry_node=np.arange(len(unique), dtype=np.int32),
            entry_frequency=np.ones(len(unique), dtype=np.uint16),
            max_node_id=len(unique) - 1 if len(unique) else 0,
            n_unique=len(unique),
        )

    def node_counts(
        self, slot_counts: np.ndarray, max_frequency: int = 1000
    ) -> np.ndarray:
        """Unique-kmer slot counts -> per-node hit counts, applying the CPU
        path's strict ``frequency > max_frequency`` entry skip
        (``mapper.pyx:64-66``). Returns uint32[max_node_id+1]."""
        slot_counts = np.asarray(slot_counts).reshape(-1)
        ok = self.entry_frequency <= max_frequency
        weights = slot_counts[self.entry_slot[ok]].astype(np.float64)
        out = np.bincount(
            self.entry_node[ok].astype(np.int64),
            weights=weights,
            minlength=self.max_node_id + 1,
        )
        return out.astype(np.uint32)

    def get(self, kmer: int) -> np.ndarray:
        """Graph nodes associated with a kmer hash (reference
        ``KmerIndex.get(hash)`` parity, used e.g. in its tests at
        ``tests/test_mapping.py:40``)."""
        slot = layout.query_table(self.table, np.array([kmer], dtype=np.uint64))[0]
        if slot < 0:
            return np.zeros(0, dtype=np.int32)
        return self.entry_node[self.entry_slot == slot]

    def kmer_counts(self, slot_counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(unique_kmers_in_slot_order, counts) — the counter view. Stored
        table words are bijectively mixed; unmix recovers the raw kmers."""
        from ..ops.u32hash import feistel_unmix, join_u64

        m_lo, m_hi = self.table.key_words()
        occupied = ~((m_lo == layout.EMPTY) & (m_hi == layout.EMPTY))
        lo, hi = feistel_unmix(m_lo, m_hi, seed=self.table.seed)
        counts = np.asarray(slot_counts).reshape(-1)
        return join_u64(lo, hi)[occupied], counts[occupied]

    def to_file(self, path) -> None:
        np.savez(
            path,
            format=np.array(["tpuidx-v4"]),
            table_key_lo=self.table.key_lo,
            table_key_hi=self.table.key_hi,
            table_max_probe=np.int64(self.table.max_probe),
            table_seed=np.int64(self.table.seed),
            entry_slot=self.entry_slot,
            entry_node=self.entry_node,
            entry_frequency=self.entry_frequency,
            max_node_id=np.int64(self.max_node_id),
            n_unique=np.int64(self.n_unique),
        )

    @classmethod
    def from_file(cls, path_or_file) -> "TpuKmerIndex":
        with np.load(path_or_file, allow_pickle=False) as data:
            fmt = str(data["format"][0]) if "format" in data else "?"
            if fmt != "tpuidx-v4":
                raise ValueError(
                    f"unsupported .tpuidx format {fmt!r} (this build reads "
                    "tpuidx-v4, which stores mixed table words; re-run "
                    "convert-index on the source .npz)"
                )
            key_lo = data["table_key_lo"]
            max_probe = int(data["table_max_probe"])
            if not 1 <= max_probe <= layout.MAX_PROBE_HARD:
                # no build configuration produces chains this deep: a value
                # outside the hard bound means a corrupt/foreign file (the
                # probe unrolls max_probe rounds, so it must stay bounded)
                raise ValueError(
                    f"corrupt .tpuidx: table_max_probe={max_probe} outside "
                    f"[1, {layout.MAX_PROBE_HARD}]"
                )
            table = layout.TableArrays(
                key_lo=key_lo,
                key_hi=data["table_key_hi"],
                n_buckets=key_lo.shape[0],
                max_probe=max_probe,
                seed=int(data["table_seed"]),
            )
            return cls(
                table=table,
                entry_slot=data["entry_slot"],
                entry_node=data["entry_node"],
                entry_frequency=data["entry_frequency"],
                max_node_id=int(data["max_node_id"]),
                n_unique=int(data["n_unique"]),
            )


def _is_tpuidx(path_or_file) -> bool:
    try:
        with np.load(path_or_file, allow_pickle=False) as data:
            return "table_key_lo" in data
    except Exception:
        return False


def load_index(source) -> TpuKmerIndex:
    """Resolve any supported index form into a TpuKmerIndex
    (reference: ``_get_kmer_index_from_args``, ``util.py:38-68``)."""
    if isinstance(source, TpuKmerIndex):
        return source
    if isinstance(source, KmerIndexArrays):
        return TpuKmerIndex.from_arrays(source)
    path = str(source)
    # the real loader tries ``file_name + ".npz"`` FIRST and falls back to
    # the bare name (graph_kmer_index ``CollisionFreeKmerIndex.from_file``),
    # so KAGE configs routinely pass extensionless paths — match that
    # resolution order exactly (when both files exist, ``.npz`` wins)
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    if _is_tpuidx(path):
        logger.info("Loading prebuilt index %s", path)
        return TpuKmerIndex.from_file(path)
    # counter-style npz?
    try:
        with np.load(path, allow_pickle=False) as data:
            if "counter_keys" in data:
                logger.info("Kmer index is counter index")
                return TpuKmerIndex.from_counter_keys(data["counter_keys"])
    except Exception:
        pass
    # the reference's pickle-file forms: a pickled CounterKmerIndex
    # (``util.py:63-66``) or a pickled IndexBundle (``util.py:51-53`` — its
    # dependency ``shared_memory_wrapper.to_file`` writes plain pickles even
    # when the file is *named* .npz); pickles are not zipfiles, so sniff first
    from .pickled import is_pickle_file, load_pickled_index

    if is_pickle_file(path):
        logger.info("Kmer index is a pickle file (counter index or bundle)")
        return load_pickled_index(path)
    # a bundle is a zip that is not itself a loadable .npz index
    try:
        arrays = load_reference_npz(path)
    except Exception:
        if zipfile.is_zipfile(path):
            return load_bundle(path)
        raise
    logger.info(
        "Loaded reference-format index: %d entries, modulo %d; re-laying out for the device",
        len(arrays.kmers),
        arrays.modulo,
    )
    return TpuKmerIndex.from_arrays(arrays)


def load_bundle(path) -> TpuKmerIndex:
    """Index bundle: a zip archive containing a kmer_index ``.npz`` member
    (``graph_kmer_index.IndexBundle`` analog, ``util.py:51-53``)."""
    with zipfile.ZipFile(path) as zf:
        names = [n for n in zf.namelist() if "kmer_index" in n]
        if not names:
            raise ValueError(f"bundle {path} has no kmer_index member")
        with zf.open(names[0]) as member:
            payload = io.BytesIO(member.read())
    if _is_tpuidx(payload):
        payload.seek(0)
        return TpuKmerIndex.from_file(payload)
    payload.seek(0)
    return TpuKmerIndex.from_arrays(load_reference_npz(payload))


def build_toy_index(
    n_unique: int, k: int, n_nodes: int, seed: int = 0, dup_fraction: float = 0.2
) -> KmerIndexArrays:
    """Synthesize a reference-layout index for tests/benchmarks."""
    rng = np.random.default_rng(seed)
    mask = np.uint64(4**k - 1) if k < 32 else np.uint64(0xFFFFFFFFFFFFFFFF)
    kmers = np.unique(rng.integers(0, 1 << 62, n_unique * 2, dtype=np.uint64) & mask)[:n_unique]
    n_dup = int(len(kmers) * dup_fraction)
    entry_kmers = np.concatenate([kmers, rng.choice(kmers, n_dup)])
    nodes = rng.integers(0, n_nodes, len(entry_kmers)).astype(np.int32)
    modulo = max(2, int(len(entry_kmers) * 1.7) | 1)
    return build_kmer_index(entry_kmers, nodes, modulo)

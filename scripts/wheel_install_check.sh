#!/bin/bash
# Wheel-level drop-in proof (VERDICT r4 item 6): build the wheel, install it
# into a CLEAN venv (offline, --no-index), and drive it from OUTSIDE the repo
# directory — console-script resolution, package-data (.cpp), the native
# compile-on-demand path, and the literal `kmer_mapper` import surface all
# come from the INSTALLED tree, not the source checkout.
#
# Runs on the CPU (JAX_PLATFORMS=cpu) so it never contends for an
# accelerator; the mapping is oracle-pinned like every other path.
# BASE_PY names the interpreter whose site-packages provide numpy and jax.
set -euo pipefail
REPO=$(cd "$(dirname "$0")/.." && pwd)
WORK=$(mktemp -d)
trap 'rm -rf "$WORK"' EXIT
BASE_PY=${BASE_PY:-python3}
unset PYTHONPATH
export JAX_PLATFORMS=cpu

cd "$REPO"
rm -rf "$WORK/dist"
"$BASE_PY" -m pip wheel . -w "$WORK/dist" --no-deps --no-build-isolation -q

# venv-from-a-venv does NOT inherit the base venv's site-packages
# (--system-site-packages points at the underlying CPython): link the base
# interpreter's site-packages via a .pth so numpy/jax resolve offline. The
# repo package must not be installed there, so the wheel's copy is the only
# kmer_mapper* on the path.
"$BASE_PY" -m venv "$WORK/venv"
BASE_SITE=$("$BASE_PY" -c 'import sysconfig; print(sysconfig.get_paths()["purelib"])')
VENV_SITE=$("$WORK/venv/bin/python" -c 'import sysconfig; print(sysconfig.get_paths()["purelib"])')
echo "$BASE_SITE" > "$VENV_SITE/_base_deps.pth"
"$WORK/venv/bin/pip" install --no-index --no-deps -q "$WORK"/dist/*.whl

cd "$WORK"  # OUTSIDE the repo: imports must resolve from the install
export KMT_WHEEL_CHECK_DIR="$WORK" KMT_REPO="$REPO"

# 1. console scripts resolve and run
"$WORK/venv/bin/kmer_mapper" --help > /dev/null
"$WORK/venv/bin/kmer_mapper_tpu" --help > /dev/null

# 2. drop-in import surface from the installed tree
"$WORK/venv/bin/python" - <<'EOF'
import os, sys
repo = os.environ["KMT_REPO"]
assert not any(p.startswith(repo) for p in sys.path if p), sys.path
import kmer_mapper
assert kmer_mapper.IS_TPU_DROP_IN
assert not os.path.abspath(kmer_mapper.__file__).startswith(repo), kmer_mapper.__file__
from kmer_mapper.mapper import map_kmers_to_graph_index  # noqa: F401
from kmer_mapper.command_line_interface import main  # noqa: F401
import kmer_mapper.encodings  # noqa: F401
print("imports ok:", kmer_mapper.__file__)
EOF

# 3. fixtures + end-to-end map via the console script, pinned to the oracle
"$WORK/venv/bin/python" - <<'EOF'
import os
import numpy as np
from kmer_mapper_tpu import oracle
from kmer_mapper_tpu.index.kmer_index import save_reference_npz

work = os.environ["KMT_WHEEL_CHECK_DIR"]
rng = np.random.default_rng(7)
reads = ["".join(rng.choice(list("ACGT"), 80)) for _ in range(400)]
with open(os.path.join(work, "reads.fa"), "w") as f:
    for i, s in enumerate(reads):
        f.write(f">r{i}\n{s}\n")
codes = oracle.encode_string("".join(reads))
sample = oracle.kmer_hashes(codes, 31)
kmers = np.unique(np.concatenate([
    rng.integers(0, 1 << 62, 3000, dtype=np.uint64), rng.choice(sample, 2000),
]))
nodes = rng.integers(0, 500, len(kmers)).astype(np.int32)
arrays = oracle.build_kmer_index(kmers, nodes, 4099)
save_reference_npz(os.path.join(work, "index.npz"), arrays)
np.save(os.path.join(work, "arrays_kmers.npy"), kmers)
np.save(os.path.join(work, "arrays_nodes.npy"), nodes)
EOF

"$WORK/venv/bin/kmer_mapper" map -i "$WORK/index.npz" -f "$WORK/reads.fa" \
  -k 31 -o "$WORK/out.npy"

"$WORK/venv/bin/python" - <<'EOF'
import os
import numpy as np
from kmer_mapper_tpu import oracle
from kmer_mapper_tpu.io import readers

work = os.environ["KMT_WHEEL_CHECK_DIR"]
got = np.load(os.path.join(work, "out.npy"))
kmers = np.load(os.path.join(work, "arrays_kmers.npy"))
nodes = np.load(os.path.join(work, "arrays_nodes.npy"))
arrays = oracle.build_kmer_index(kmers, nodes, 4099)
with open(os.path.join(work, "reads.fa"), "rb") as f:
    data = f.read()
seqs = [l for l in data.decode().split("\n") if l and not l.startswith(">")]
q = oracle.kmer_hashes_ragged(
    oracle.encode_string("".join(seqs)), np.array([len(s) for s in seqs]), 31
)
want = oracle.map_kmers_to_index(arrays, q, max_node_id=int(nodes.max()))
np.testing.assert_array_equal(got, want)
print(f"end-to-end counts bit-exact: {int(got.sum())} node hits")
EOF

echo "WHEEL INSTALL CHECK: PASS"

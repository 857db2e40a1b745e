"""chip_smoke.py on the CPU: its phase functions at toy size against the
oracle, its refusal to run without a GPU (and without the repo), the format
of its last line, and the four-device phase on 4 virtual CPU devices."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from kmer_mapper_tpu.io import readers  # noqa: E402

TOY_CHUNK = 1 << 14  # CLI --chunk-size for toy runs


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """Toy reads (48 bp), an index of 4000 kmers and its oracle twin."""
    workdir = tmp_path_factory.mktemp("smoke")
    rng = np.random.default_rng(5)
    bases = chip_smoke.make_reads(rng, 400, read_len=48)
    kmers, nodes = chip_smoke.make_index_entries(rng, bases, 4000)
    index, path = chip_smoke.build_index(kmers, nodes, workdir)
    return SimpleNamespace(
        rng=rng, bases=bases, index=index, path=path,
        arrays=chip_smoke.oracle_index(kmers, nodes), workdir=workdir,
    )


def test_make_index_entries_draws_half_from_reads(toy):
    kmers, nodes = chip_smoke.make_index_entries(np.random.default_rng(1), toy.bases, 2000)
    unique = np.unique(kmers)
    assert len(unique) == 2000 and len(kmers) == 2200 and len(nodes) == len(kmers)
    windows = chip_smoke.oracle.kmer_hashes_ragged(
        chip_smoke.oracle.encode_bytes(toy.bases.reshape(-1)),
        np.full(len(toy.bases), toy.bases.shape[1]), chip_smoke.K,
    )
    assert np.isin(unique, windows).sum() == 1000


def test_write_fastq_frames_back_to_the_reads(tmp_path, toy):
    path = tmp_path / "r.fq"
    chip_smoke.write_fastq(path, toy.bases, block=64)
    chunks = list(readers.read_chunks(readers.open_bytes(str(path)), fmt="fastq"))
    got = np.concatenate([c.bases for c in chunks])
    np.testing.assert_array_equal(got, toy.bases.reshape(-1))
    assert sum(c.n_reads for c in chunks) == len(toy.bases)


def test_phase_fastq_toy(toy):
    chip_smoke.phase_fastq(
        toy.workdir, toy.path, toy.arrays, toy.bases, subset_stride=3,
        chunk_size=TOY_CHUNK,
    )


def test_phase_ragged_toy(toy):
    reads = chip_smoke.make_ragged(toy.rng, toy.bases, 300)
    assert {len(r) for r in reads} <= set(range(10, 49))
    chip_smoke.phase_ragged(toy.workdir, toy.path, toy.arrays, reads, chunk_size=TOY_CHUNK)


def test_phase_library_toy(toy):
    chip_smoke.phase_library(toy.index, toy.arrays, toy.rng, 3000)


@pytest.mark.parametrize("buf", [1 << 13, 1 << 16])
def test_time_plane_vs_slice_toy(toy, capsys, buf):
    """Full chunks, and one chunk holding fewer reads than its capacity."""
    chip_smoke.time_plane_vs_slice(toy.index, toy.bases, buf, max_chunks=2, reps=1)
    out = capsys.readouterr().out
    assert "plane step" in out and "slice step" in out


def test_phase_four_on_virtual_devices(toy):
    """The --four phase over 4 of the test session's virtual CPU devices."""
    chip_smoke.phase_four(toy.workdir, toy.path, toy.bases[:200], n_devices=4,
                          chunk_size=TOY_CHUNK)


def test_require_gpu_refuses_other_platforms():
    import jax

    with pytest.raises(SystemExit, match="not a GPU"):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu([])
    chip_smoke.require_gpu([SimpleNamespace(platform="gpu")])


def test_result_line_format():
    devs = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")] * 4
    line = chip_smoke.result_line(devs)
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4},
    }
    assert "\n" not in line


def _run_script(script: Path, cwd: Path, pythonpath: str | None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    if pythonpath:
        env["PYTHONPATH"] = pythonpath
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_script_refuses_without_gpu():
    """Run as the driver runs it, on a machine without a GPU: non-zero exit
    and no result line."""
    proc = _run_script(REPO / "chip_smoke.py", REPO, str(REPO))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_script_alone_in_a_directory_fails(tmp_path):
    """chip_smoke.py without the rest of the repo: non-zero exit, no result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_script(tmp_path / "chip_smoke.py", tmp_path, None)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

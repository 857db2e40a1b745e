"""Placement of the persistent compilation cache (utils/compile_cache.py):
the environment's JAX_COMPILATION_CACHE_DIR wins and nothing is set in code;
otherwise the cache is <checkout>/.jax_cache, never a temporary path."""
import tempfile
from pathlib import Path

import jax
import pytest

from kmer_mapper_tpu.utils import compile_cache

CHECKOUT = Path(__file__).resolve().parent.parent


@pytest.fixture
def updates(monkeypatch):
    """Record jax.config.update calls instead of applying them (so this
    worker's compilations do not start writing a cache)."""
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    return calls


def test_env_var_set_sets_nothing(monkeypatch, updates, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert compile_cache.enable_compile_cache() == str(tmp_path / "cc")
    assert updates == []


def test_env_var_unset_uses_checkout_dir(monkeypatch, updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == str(CHECKOUT / ".jax_cache")
    assert updates == [("jax_compilation_cache_dir", path)]
    assert ".jax_cache/" in (CHECKOUT / ".gitignore").read_text()


def test_never_under_a_temporary_path(monkeypatch, updates, tmp_path):
    """The path does not follow TMPDIR, the process or the time: a moved
    cache never hits."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    first = compile_cache.enable_compile_cache()
    assert not first.startswith(tempfile.gettempdir())
    assert first == compile_cache.enable_compile_cache()


def test_cli_main_enables_the_cache(monkeypatch):
    from kmer_mapper_tpu import cli

    calls = []
    monkeypatch.setattr(compile_cache, "enable_compile_cache", lambda: calls.append(1))
    monkeypatch.setattr(cli, "run_argument_parser", lambda args: calls.append(args))
    cli.main(["map", "-f", "x"])
    assert calls == [1, ["map", "-f", "x"]]

"""The persistent compilation cache goes where JAX_COMPILATION_CACHE_DIR
says, or else to one fixed, git-ignored directory in the checkout."""

import pathlib

import jax
import pytest

from softgnss_tpu import compile_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_wins(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper changes nothing
    assert jax.config.jax_compilation_cache_dir == before


def test_fixed_default_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.enable_compile_cache()
    second = compile_cache.enable_compile_cache()
    assert first == second == jax.config.jax_compilation_cache_dir
    path = pathlib.Path(first)
    repo = pathlib.Path(__file__).resolve().parent.parent
    assert path == repo / ".jax_cache"
    ignored = (repo / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored

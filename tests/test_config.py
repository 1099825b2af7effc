"""moby_tpu.config: the pinned matmul precision and the compile-cache
directory."""

import os

import jax
import pytest

import moby_tpu
from moby_tpu import config


def test_matmul_precision_highest_after_import():
    assert moby_tpu.config is config
    assert jax.config.jax_default_matmul_precision == "highest"


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_env_set(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert config.use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_env_unset(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = config.use_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(moby_tpu.__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(root, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()
